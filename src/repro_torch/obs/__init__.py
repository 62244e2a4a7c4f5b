"""Observability layer of the PyTorch port: span tracer, Chrome-trace
export, flight recorder and the EdgeCIM energy meter.

Own copies of the `repro.obs` modules the engine and launcher call
(stdlib and numpy only; the energy meter runs the port's copy of the
cost model, `repro_torch.core`), so the port imports nothing of the JAX
package.  The tracer is this package's own process-wide singleton
(`get_tracer()`), enabled by `REPRO_TRACE=1` as the JAX one is.
"""
from .digest import QuantileDigest
from .energy import EnergyMeter, slm_spec_from_model_config
from .export import chrome_trace
from .recorder import FlightRecorder
from .trace import NULL_SPAN, Tracer, get_tracer

__all__ = [
    "EnergyMeter",
    "FlightRecorder",
    "NULL_SPAN",
    "QuantileDigest",
    "Tracer",
    "chrome_trace",
    "get_tracer",
    "slm_spec_from_model_config",
]
