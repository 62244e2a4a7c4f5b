"""Energy-aware serving metrics via the EdgeCIM analytical cost model.

The paper's headline claims are tokens/s AND tokens/J (336 tok/s,
173 tok/J at INT4); the serving stack measures the first but, running
on commodity hardware, cannot measure the second.  This module closes
the gap the way the paper does — analytically: it maps the runtime's
`ModelConfig` onto the simulator's `SLMSpec` and charges every decoded
/ prefilled token its CIM cost (`core/simulator.py` on `core/hw.py`
defaults), so `/metrics` and bench summaries report *simulated* energy
and tokens/J for the exact token/shape stream the engine ran.

These numbers are a model, not a measurement — they answer "what would
this serving trace cost on the EdgeCIM accelerator", which is the
observability hook ROADMAP's quantization item asks for.

Cost shape: a decode step at KV length `seq` is linear in seq (the KV
stream is the only seq-dependent term; weights are streamed in full
regardless), so the meter samples `decode_token` at two seq points and
charges per-token as e0 + de*seq thereafter — two simulator calls at
construction, pure arithmetic on the hot path.  Prefill is charged per
token at the GEMM-regime average cost (weights amortized across the
chunk).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..core.hw import HWConfig
from ..core.simulator import EdgeCIMSimulator
from ..core.workload import SLMSpec

_REF_PREFILL = 128      # chunk size for the per-token prefill estimate
_SEQ_LO, _SEQ_HI = 64.0, 1024.0     # linear-fit sample points


def slm_spec_from_model_config(cfg: Any) -> SLMSpec:
    """Map the runtime `models.config.ModelConfig` onto the simulator's
    `SLMSpec`.  Dense/GQA/MLA/local-attention map exactly; MoE maps to
    the active-expert stream; SSM-bearing families (xlstm, zamba) are
    approximated as pure recurrent-state models sized from the config —
    good enough for energy attribution, not for DSE."""
    mla = getattr(cfg, "mla", None)
    moe = getattr(cfg, "moe", None) if cfg.family == "moe" else None
    hd = cfg.hd()

    kw: Dict[str, Any] = dict(
        name=cfg.name,
        n_layers=cfg.n_layers,
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_ff=cfg.d_ff,
        vocab=cfg.vocab,
        head_dim=cfg.head_dim,
        ffn_gated=cfg.ffn_gated,
        qkv_bias=cfg.qkv_bias,
        tie_embeddings=cfg.tie_embeddings,
    )

    if cfg.attn_kind == "mla" and mla is not None:
        kw.update(attn_kind="mla",
                  mla_kv_lora=mla.kv_lora_rank,
                  mla_rope_dim=mla.qk_rope_head_dim,
                  mla_q_nope=mla.qk_nope_head_dim)

    if moe is not None:
        kw.update(n_experts=moe.n_experts, top_k=moe.top_k,
                  n_shared_experts=moe.n_shared_experts,
                  d_ff_expert=moe.d_ff_expert)

    if cfg.local_window and cfg.local_pattern:
        kw.update(local_window=cfg.local_window,
                  local_ratio=(cfg.local_pattern - 1) / cfg.local_pattern)

    ssm = getattr(cfg, "ssm", None)
    if cfg.family in ("xlstm", "zamba") and ssm is not None:
        # recurrent state replaces the KV stream; size it from the
        # config's expansion factors (mamba2-style: d_inner x d_state
        # matrix state per layer; xlstm mLSTM is of the same shape)
        d_inner = int(cfg.d_model * getattr(ssm, "expand", 2))
        state = float(d_inner * getattr(ssm, "d_state", 64))
        # in/out projections + conv + gates, ~3x d_model*d_inner
        w_ssm = 3.0 * cfg.d_model * d_inner
        n_ssm = cfg.n_layers
        if cfg.family == "zamba" and getattr(cfg, "zamba", None):
            # keep the shared attention block as one attn layer's worth
            n_ssm = max(cfg.n_layers - 1, 1)
        kw.update(n_ssm_layers=n_ssm,
                  ssm_state_elems_per_layer=state,
                  ssm_weight_elems_per_layer=w_ssm,
                  ssm_macs_per_layer=w_ssm + state)
        if n_ssm == cfg.n_layers:
            kw.update(attn_kind="none")

    return SLMSpec(**kw)


class EnergyMeter:
    """Charges engine token traffic against the CIM cost model.

    Construction runs three simulator evaluations (two decode seq
    points + one prefill chunk); after that `charge_decode` /
    `charge_prefill` are a multiply-add each, cheap enough to sit
    unconditionally in the engine step loop.
    """

    def __init__(self, model_cfg: Any, *, hw: Optional[HWConfig] = None,
                 w_bits: int = 4, a_bits: int = 8, tp: int = 1):
        """`tp` models tensor parallelism: the engine's weight/KV
        stream is split across `tp` accelerators.  Total bytes moved
        (hence total joules) stay what one accelerator would pay, but
        each device streams 1/tp of them concurrently, so simulated
        wall time divides by tp — the aggregate-bandwidth claim TP
        exists to cash in.  tp == 1 reporting is unchanged."""
        self.hw = hw or HWConfig()
        self.w_bits = w_bits
        self.a_bits = a_bits
        self.tp = max(int(tp), 1)
        self.spec = slm_spec_from_model_config(model_cfg)
        sim = EdgeCIMSimulator()
        lo = sim.decode_token(self.spec, self.hw, _SEQ_LO,
                              w_bits=w_bits, a_bits=a_bits)
        hi = sim.decode_token(self.spec, self.hw, _SEQ_HI,
                              w_bits=w_bits, a_bits=a_bits)
        span = _SEQ_HI - _SEQ_LO
        self._de_j = (hi.joules - lo.joules) / span
        self._e0_j = lo.joules - self._de_j * _SEQ_LO
        self._ds_s = (hi.seconds - lo.seconds) / span
        self._s0_s = lo.seconds - self._ds_s * _SEQ_LO
        pf = sim.prefill(self.spec, self.hw, _REF_PREFILL,
                         w_bits=w_bits, a_bits=a_bits)
        self._prefill_j_per_tok = pf.joules / _REF_PREFILL
        self._prefill_s_per_tok = pf.seconds / _REF_PREFILL

        self.decode_j = 0.0
        self.prefill_j = 0.0
        self.sim_s = 0.0
        self.decode_sim_s = 0.0     # decode-only modeled time: the
        # predicted clock the drift auditor (obs/drift.py) holds
        # against Telemetry.decode_s — prefill must not blur it
        self.decode_tokens = 0
        self.prefill_tokens = 0

    def reset(self) -> None:
        """Zero the accumulators (keeps the fitted cost model) — bench
        warmup resets this alongside Telemetry so reported tokens/J
        covers only the measured window."""
        self.decode_j = self.prefill_j = self.sim_s = 0.0
        self.decode_sim_s = 0.0
        self.decode_tokens = self.prefill_tokens = 0

    # -- accounting -----------------------------------------------------
    def decode_cost_j(self, seq: float) -> float:
        """Simulated joules for ONE decode token at KV length `seq`."""
        return self._e0_j + self._de_j * seq

    def charge_decode(self, n_tokens: int, mean_seq: float) -> None:
        """Charge `n_tokens` decode-lane tokens at mean KV length
        `mean_seq` (cost is linear in seq, so the mean is exact)."""
        if n_tokens <= 0:
            return
        self.decode_j += n_tokens * (self._e0_j + self._de_j * mean_seq)
        sim_s = n_tokens * (self._s0_s + self._ds_s * mean_seq)
        self.sim_s += sim_s
        self.decode_sim_s += sim_s
        self.decode_tokens += n_tokens

    def charge_prefill(self, n_tokens: int) -> None:
        if n_tokens <= 0:
            return
        self.prefill_j += n_tokens * self._prefill_j_per_tok
        self.sim_s += n_tokens * self._prefill_s_per_tok
        self.prefill_tokens += n_tokens

    # -- reporting ------------------------------------------------------
    @property
    def total_j(self) -> float:
        return self.decode_j + self.prefill_j

    def tokens_per_j(self) -> float:
        return self.decode_tokens / self.total_j if self.total_j > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        """Keys merged into the engine summary / `/metrics` payload.
        `sim_*` prefix flags every value as cost-model output, not a
        wall-clock measurement.

        At tp > 1 the aggregate keys stay engine-level (energy sums
        across shards; wall time divides by the tp-way bandwidth) and
        per-device keys carry each shard's slice, so a fleet rollup of
        TP engines still sums joules correctly (`sim_energy_j` is in
        `fleet.router._SUM_KEYS`; the per-device keys average)."""
        wall_s = self.sim_s / self.tp
        out = {
            "sim_energy_j": self.total_j,
            "sim_decode_energy_j": self.decode_j,
            "sim_prefill_energy_j": self.prefill_j,
            "sim_time_s": wall_s,
            # decode-only modeled wall time (tp-scaled like sim_time_s):
            # the drift audit's predicted clock
            "sim_decode_time_s": self.decode_sim_s / self.tp,
            "sim_decode_tokens": float(self.decode_tokens),
            "sim_tokens_per_j": self.tokens_per_j(),
            "sim_tokens_per_s": (self.decode_tokens / wall_s
                                 if wall_s > 0 else 0.0),
            # the precision the cost model was fitted at (engine sets
            # these from ServeConfig: int4 = the paper's operating
            # point, 16/16 = the fp baseline)
            "sim_w_bits": float(self.w_bits),
            "sim_a_bits": float(self.a_bits),
        }
        if self.tp > 1:
            out.update({
                "sim_tp": float(self.tp),
                "sim_energy_j_per_device": self.total_j / self.tp,
                "sim_decode_energy_j_per_device": self.decode_j / self.tp,
                "sim_time_s_per_device": wall_s,
            })
        return out
