"""A run with its timed path broken underneath comes out not correct:
once for each fault a serving cell can have.  (A cell on one chip has
no exchange between chips to leave out.)"""
import pytest

from _cpu import CELLS, smoke_run


def _state_unchanged(engine):
    """Every step returns the recurrent state and K/V pools unchanged."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t.clone()

    def put(dst, src):
        for k, v in dst.items():
            if isinstance(v, dict):
                put(v, src[k])
            else:
                v.copy_(src[k])
    run = engine._dispatch

    def dispatch(*a, **k):
        before = walk(engine.state)
        out = run(*a, **k)
        put(engine.state, before)
        return out
    engine._dispatch = dispatch


def _half_batch(engine):
    """The upper half of the lanes gets the lower half's logits."""
    run = engine._dispatch

    def dispatch(*a, **k):
        out = run(*a, **k).clone()
        h = out.shape[0] // 2
        out[h:2 * h] = out[:h]
        return out
    engine._dispatch = dispatch


def _token_altered(engine):
    """Every fifth sampling call hands every lane another token."""
    run, n = engine._sample_rows, [0]

    def sample(rows):
        out = run(rows)
        n[0] += 1
        if n[0] % 5 == 0:
            out = (out + 1) % rows.shape[-1]
        return out
    engine._sample_rows = sample


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", CELLS)
def check_fault_is_caught(cell, fault):
    out = smoke_run(cell, fault=fault, seconds=1.0)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
