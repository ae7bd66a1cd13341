"""The unified predictor API, ported from ``repro.predict``.

A ``Predictor`` turns a list (or nested groups) of ``KernelCall``/
``CommCall`` into an ``Estimate``::

    from repro_torch.predict import get_predictor
    est = get_predictor("roofline", hw).predict(calls)

Ported, all of it: the call and estimate types, batching, the comm
regressor, the backends (``SynPerfPredictor`` over the port's trained
``core.estimator.PipeWeave``), the placement objectives, and
``SweepPredictor``, which prices one trace on many registry TPUs at once.
"""
from repro_torch.predict.api import (
    CommCall,
    Estimate,
    KernelCall,
    Predictor,
    UntrainedFamilyError,
    flatten_calls,
)
from repro_torch.predict.batching import FeatureCache, canonical_x, group_calls, task_sig
from repro_torch.predict.comm import CommRegressor
from repro_torch.predict.objective import (
    OBJECTIVES,
    Objective,
    UnpricedHardwareError,
    get_objective,
    trace_cost_usd,
)
from repro_torch.predict.sweep import SweepComparison, SweepPredictor, SweepResult, hw_split
from repro_torch.predict.backends import (
    PREDICTORS,
    BaselinePredictor,
    BasePredictor,
    CallableTimesPredictor,
    OraclePredictor,
    RooflinePredictor,
    SynPerfPredictor,
    get_predictor,
)

__all__ = [
    "CommCall",
    "CommRegressor",
    "Estimate",
    "FeatureCache",
    "KernelCall",
    "OBJECTIVES",
    "Objective",
    "PREDICTORS",
    "Predictor",
    "UnpricedHardwareError",
    "UntrainedFamilyError",
    "BaselinePredictor",
    "BasePredictor",
    "CallableTimesPredictor",
    "OraclePredictor",
    "RooflinePredictor",
    "SweepComparison",
    "SweepPredictor",
    "SweepResult",
    "SynPerfPredictor",
    "canonical_x",
    "flatten_calls",
    "get_objective",
    "get_predictor",
    "group_calls",
    "hw_split",
    "task_sig",
    "trace_cost_usd",
]
