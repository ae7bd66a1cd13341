"""The unified predictor API, ported from ``repro.predict``.

A ``Predictor`` turns a list (or nested groups) of ``KernelCall``/
``CommCall`` into an ``Estimate``::

    from repro_torch.predict import get_predictor
    est = get_predictor("roofline", hw).predict(calls)

Ported: the call and estimate types, batching, the comm regressor and the
backends. ``SynPerfPredictor`` raises until the trained estimator is
ported; ``objective`` and ``sweep`` are still to port.
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
    "PREDICTORS",
    "Predictor",
    "UntrainedFamilyError",
    "BaselinePredictor",
    "BasePredictor",
    "CallableTimesPredictor",
    "OraclePredictor",
    "RooflinePredictor",
    "SynPerfPredictor",
    "canonical_x",
    "flatten_calls",
    "get_predictor",
    "group_calls",
    "task_sig",
]
