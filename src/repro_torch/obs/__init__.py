"""Observability layer of the PyTorch port: span tracer, exporters
(Chrome trace, Prometheus text), flight recorder, the EdgeCIM energy
meter, and the SLO layer (quantile sketches, burn-rate alerting, the
simulated-vs-measured drift audit).

Own copies of the `repro.obs` modules (stdlib and numpy only; the energy
meter runs the port's copy of the cost model, `repro_torch.core`), so
the port imports nothing of the JAX package.  The tracer is this
package's own process-wide singleton (`get_tracer()`), enabled by
`REPRO_TRACE=1` as the JAX one is.
"""
from .digest import QuantileDigest, merge_digest_dicts
from .drift import DriftAuditor
from .energy import EnergyMeter, slm_spec_from_model_config
from .export import chrome_trace, prometheus_text
from .recorder import FlightRecorder
from .slo import BurnRatePolicy, SLOMonitor, SLOSpec, parse_slos
from .trace import NULL_SPAN, Tracer, get_tracer

__all__ = [
    "BurnRatePolicy",
    "DriftAuditor",
    "EnergyMeter",
    "FlightRecorder",
    "NULL_SPAN",
    "QuantileDigest",
    "SLOMonitor",
    "SLOSpec",
    "Tracer",
    "chrome_trace",
    "get_tracer",
    "merge_digest_dicts",
    "parse_slos",
    "prometheus_text",
    "slm_spec_from_model_config",
]
