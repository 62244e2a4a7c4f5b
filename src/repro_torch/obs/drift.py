"""Digital-twin drift audit: CIM-simulator predictions vs measurement.

EdgeCIM's serving stack carries its own cost model: `EnergyMeter`
predicts what each decode step *should* cost on the modeled CIM array
(`sim_*` in every summary).  The paper's co-design argument assumes the
model tracks reality — edge-SLM characterization work shows measured
throughput/energy routinely diverging from modeled numbers by
config-dependent factors, so this module watches the ratio
continuously instead of trusting the calibration once.

Per replica, each audit tick compares the deltas of two cumulative
decode clocks:

    measured   Telemetry.decode_s        (wall time in decode steps)
    predicted  EnergyMeter.decode_sim_s  (modeled CIM time, same steps)

Token counts cancel (both clocks cover the same steps), so the raw
tick ratio is predicted/measured seconds.  Its absolute level is
meaningless on a host-CPU simulator (the modeled CIM array is faster
than the interpreting CPU by an arbitrary config-dependent factor), so
drift is defined RELATIVE to a calibration baseline learned from the
replica's own first `calib_ticks` of traffic:

    x_t   = log(d_sim_s / d_meas_s)          per-tick log-ratio
    ewma  = (1-a)*ewma + a*x_t               smoothed level
    mu0   = mean(x_1..x_calib)               learned baseline
    sim_drift_ratio = exp(ewma - mu0)        ~1.0 while tracking

A replica that slows down (contention, thermal, mis-modeled config
change) drives the ratio UP (predicted time stays put, measured time
grows the denominator... i.e. d_meas grows so x falls — see sign note
below); a simulator overestimating cost drives it down.  Detection is
two-sided CUSUM on the centered log-ratio — the standard change-point
statistic: it accumulates small persistent shifts that a threshold on
the instantaneous value would miss, and ignores zero-mean noise:

    s+ = max(0, s+ + (x_t - mu0 - k))        k = slack (ignores |shift|<k)
    s- = max(0, s- - (x_t - mu0 + k))
    alarm when max(s+, s-) > h

Sign note: sim_drift_ratio > 1 means the simulator now predicts MORE
time relative to measurement than at calibration (measurement got
faster / model got pessimistic); < 1 means measurement degraded
relative to the model — the "replica slowed down" page-worthy case.
Both directions alarm: either way the digital twin stopped tracking.

Pure stdlib; fed by `FleetRouter.poll_slo` from published snapshots,
alarms recorded into the replica's flight recorder and exported as
`sim_drift_*` gauges in /metrics.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, Optional


class DriftAuditor:
    """EWMA + two-sided CUSUM on the log sim/measured decode-time ratio.

    `observe()` takes CUMULATIVE clocks (monotone counters from the
    snapshot); ticks without fresh decode activity are skipped so idle
    replicas neither alarm nor decay their statistics.
    """

    def __init__(self, *, ewma_alpha: float = 0.3, calib_ticks: int = 5,
                 cusum_k: float = 0.25, cusum_h: float = 2.0,
                 min_delta_s: float = 1e-6, max_events: int = 64):
        assert 0.0 < ewma_alpha <= 1.0 and calib_ticks >= 1
        self.ewma_alpha = ewma_alpha
        self.calib_ticks = calib_ticks
        self.cusum_k = cusum_k          # slack: |log-shift| below this
        self.cusum_h = cusum_h          # is treated as noise
        self.min_delta_s = min_delta_s
        # cumulative marks from the previous tick
        self._last_meas_s: Optional[float] = None
        self._last_sim_s: Optional[float] = None
        # statistics
        self.ticks = 0                  # ticks with decode activity
        self.ewma: Optional[float] = None
        self.mu0: Optional[float] = None
        self._calib_sum = 0.0
        self.s_pos = 0.0
        self.s_neg = 0.0
        self.alarm = False
        self.alarms = 0                 # rising edges
        self.events: Deque[Dict] = deque(maxlen=max_events)

    @property
    def calibrated(self) -> bool:
        return self.mu0 is not None

    def observe(self, now: float, measured_s: float,
                sim_s: float) -> Optional[Dict]:
        """One audit tick over cumulative decode clocks; returns an
        alarm event dict on a rising edge, else None."""
        lm, ls = self._last_meas_s, self._last_sim_s
        self._last_meas_s, self._last_sim_s = measured_s, sim_s
        if lm is None:
            return None
        d_meas = measured_s - lm
        d_sim = sim_s - ls
        if d_meas < self.min_delta_s or d_sim < self.min_delta_s:
            return None                 # idle (or rewound) tick
        x = math.log(d_sim / d_meas)
        self.ticks += 1
        self.ewma = (x if self.ewma is None else
                     (1.0 - self.ewma_alpha) * self.ewma
                     + self.ewma_alpha * x)
        if self.mu0 is None:
            self._calib_sum += x
            if self.ticks >= self.calib_ticks:
                self.mu0 = self._calib_sum / self.ticks
            return None                 # no detection until calibrated
        xc = x - self.mu0
        self.s_pos = max(0.0, self.s_pos + xc - self.cusum_k)
        self.s_neg = max(0.0, self.s_neg - xc - self.cusum_k)
        tripped = max(self.s_pos, self.s_neg) > self.cusum_h
        event = None
        if tripped and not self.alarm:
            self.alarms += 1
            event = {"t_s": now, "kind": "drift_alarm",
                     "ratio": self.drift_ratio,
                     "cusum": max(self.s_pos, self.s_neg),
                     "direction": ("sim_overpredicts" if
                                   self.s_pos >= self.s_neg else
                                   "measured_degraded")}
            self.events.append(event)
        self.alarm = tripped
        return event

    @property
    def drift_ratio(self) -> float:
        """Calibration-normalized ratio: ~1.0 while the twin tracks.
        NaN until calibrated (exported as absent, never a fake 1.0)."""
        if self.ewma is None or self.mu0 is None:
            return float("nan")
        return math.exp(self.ewma - self.mu0)

    @property
    def measured_ratio(self) -> float:
        """Raw (un-normalized) smoothed sim/measured ratio —
        informational: how much faster the modeled CIM array is than
        the host actually running the simulation."""
        if self.ewma is None:
            return float("nan")
        return math.exp(self.ewma)

    def summary(self) -> Dict:
        """Gauges for /metrics and bench rows (NaN = not calibrated;
        the exporter drops non-finite values)."""
        return {
            "sim_drift_ratio": self.drift_ratio,
            "sim_drift_alarm": 1.0 if self.alarm else 0.0,
            "sim_drift_alarms": float(self.alarms),
            "sim_drift_cusum": max(self.s_pos, self.s_neg),
            "sim_measured_ratio": self.measured_ratio,
            "sim_drift_ticks": float(self.ticks),
        }
