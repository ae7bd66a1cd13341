"""The predictor's core, ported from ``repro.core``: decompose -> schedule
-> featurize, the hwsim oracle, the kernel dataset generator, the
end-to-end workload generator and the ``core.tuner`` compatibility shim
(numpy only; held equal to the reference on the same inputs), and the
trained estimator: the per-family MLPs (``nn``, trained with PyTorch on
the card), ``estimator.PipeWeave``, the §VI ``baselines`` and the P80
``quantile`` ceiling."""
