"""The analytic substrate of the predictor, ported from ``repro.core``:
decompose -> schedule -> featurize, the hwsim oracle, the kernel dataset
generator and the ``core.tuner`` compatibility shim. Numpy only; held
equal to the reference on the same inputs."""
