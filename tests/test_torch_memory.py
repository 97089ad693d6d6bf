"""spann3r_torch spatial memory against the JAX package, on the CPU.

The read is held against JAX `memory_read` on its XLA path and against the
fused Pallas kernel (interpret mode); the write path (`add_mem_check`:
dedup, append, spill, prune) is held step by step over several prune
cycles, including the order of the kept slots, which pins the port to
`lax.top_k`'s tie order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spann3r_tpu.config import MemoryConfig as JMemoryConfig
from spann3r_tpu.models import memory as JM
from spann3r_tpu.ops import pallas_memory
from spann3r_tpu.ops.layers import init_layer_norm, layer_norm as jax_layer_norm
from spann3r_torch.config import MemoryConfig
from spann3r_torch.models import memory as TM
from spann3r_torch.ops import memory_read as TMR
from spann3r_torch.utils.convert import memory_state_from_jax

D, P, C = 64, 16, 256
READ_TOL = 2e-5


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pallas_memory.pl.pallas_call
    monkeypatch.setattr(pallas_memory.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


class _Norms(torch.nn.Module):
    def __init__(self, jnorms):
        super().__init__()
        for name in ("norm_q", "norm_k", "norm_v"):
            ln = torch.nn.LayerNorm(D, eps=1e-6)
            ln.weight.data = torch.from_numpy(np.array(jnorms[name]["scale"]))
            ln.bias.data = torch.from_numpy(np.array(jnorms[name]["bias"]))
            setattr(self, name, ln)


def _norms(seed):
    rng = np.random.default_rng(seed)
    jn = {}
    for name in ("norm_q", "norm_k", "norm_v"):
        p = init_layer_norm(D)
        p["scale"] = jnp.asarray(1 + 0.1 * rng.standard_normal(D).astype(np.float32))
        p["bias"] = jnp.asarray(0.1 * rng.standard_normal(D).astype(np.float32))
        jn[name] = p
    return jn, _Norms(jn)


def _bank(seed, n_frames, p=8):
    """A JAX bank with n_frames appended frames (p tokens each)."""
    rng = np.random.default_rng(seed)
    state = JM.init_memory(1, C, D, dtype=jnp.float32)
    for _ in range(n_frames):
        kf = jnp.asarray(rng.standard_normal((1, p, D)).astype(np.float32))
        state = JM.add_mem(state, kf, kf * 0.5 + 0.1)
    state = state._replace(attn=jnp.asarray(
        rng.random((1, C)).astype(np.float32)) * (jnp.arange(C) < state.size[0]))
    return state


BANKS = {"empty": 0, "partial": 5, "full": C // 8}
THRESHOLDS = [0.0, 5e-4, 0.05]


def _n(t):
    return t.detach().numpy()


def _state_np(state):
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("bank", list(BANKS))
@pytest.mark.parametrize("attn_thresh", THRESHOLDS)
def test_memory_read_vs_jax_xla_path(bank, attn_thresh, monkeypatch):
    monkeypatch.setenv("SPANN3R_PALLAS_MEMREAD", "0")
    jn, tn = _norms(1)
    state = _bank(2, BANKS[bank])
    q = np.random.default_rng(3).standard_normal((1, P, D)).astype(np.float32)
    ref_out, ref_state = JM.memory_read(jn, state, jnp.asarray(q),
                                        attn_thresh=attn_thresh)
    out, new = TM.memory_read(tn, memory_state_from_jax(_state_np(state)),
                              torch.from_numpy(q), attn_thresh=attn_thresh)
    np.testing.assert_allclose(_n(out), np.asarray(ref_out),
                               rtol=READ_TOL, atol=READ_TOL)
    np.testing.assert_allclose(_n(new.attn), np.asarray(ref_state.attn),
                               rtol=READ_TOL, atol=READ_TOL)


@pytest.mark.parametrize("bank", list(BANKS))
@pytest.mark.parametrize("attn_thresh", THRESHOLDS)
def test_memory_read_attention_vs_pallas_kernel(interpret_mode, bank,
                                                attn_thresh):
    """The kernel-level function on the layer-normed operands."""
    jn, _ = _norms(4)
    state = _bank(5, BANKS[bank])
    q = jnp.asarray(np.random.default_rng(6).standard_normal((1, P, D))
                    .astype(np.float32))
    qn = jax_layer_norm(jn["norm_q"], q)
    kn = jax_layer_norm(jn["norm_k"], state.k)
    vn = jax_layer_norm(jn["norm_v"], state.v)
    ref_out, ref_asum = pallas_memory.memory_read_attention(
        qn, kn, vn, state.size[0], attn_thresh, block_c=128)
    to_t = lambda a: torch.from_numpy(np.array(a))
    out, asum = TMR.memory_read_attention(to_t(qn), to_t(kn), to_t(vn),
                                          to_t(state.size), attn_thresh)
    np.testing.assert_allclose(_n(out), np.asarray(ref_out),
                               rtol=READ_TOL, atol=READ_TOL)
    np.testing.assert_allclose(_n(asum), np.asarray(ref_asum),
                               rtol=READ_TOL, atol=READ_TOL)


def test_memory_read_vs_jax_kernel_dispatch(interpret_mode, monkeypatch):
    """JAX memory_read routed to the Pallas kernel (its TPU default)."""
    monkeypatch.setenv("SPANN3R_PALLAS_MEMREAD", "1")
    jn, tn = _norms(7)
    state = _bank(8, 12)
    q = np.random.default_rng(9).standard_normal((1, P, D)).astype(np.float32)
    ref_out, ref_state = JM.memory_read(jn, state, jnp.asarray(q),
                                        attn_thresh=5e-4)
    out, new = TM.memory_read(tn, memory_state_from_jax(_state_np(state)),
                              torch.from_numpy(q), attn_thresh=5e-4)
    np.testing.assert_allclose(_n(out), np.asarray(ref_out),
                               rtol=READ_TOL, atol=READ_TOL)
    np.testing.assert_allclose(_n(new.attn), np.asarray(ref_state.attn),
                               rtol=READ_TOL, atol=READ_TOL)


def test_memory_read_multi_stream_plain():
    """The plain read takes B > 1 streams with their own sizes."""
    jn, tn = _norms(10)
    rng = np.random.default_rng(11)
    a, b = _bank(12, 3), _bank(13, 9)
    state = jax.tree.map(lambda x, y: jnp.concatenate([x, y]), a, b)
    q = rng.standard_normal((2, P, D)).astype(np.float32)
    ref_out, ref_state = JM.memory_read(jn, state, jnp.asarray(q),
                                        attn_thresh=5e-4)
    out, new = TM.memory_read(tn, memory_state_from_jax(_state_np(state)),
                              torch.from_numpy(q), attn_thresh=5e-4)
    np.testing.assert_allclose(_n(out), np.asarray(ref_out),
                               rtol=READ_TOL, atol=READ_TOL)
    np.testing.assert_allclose(_n(new.attn), np.asarray(ref_state.attn),
                               rtol=READ_TOL, atol=READ_TOL)


# ---------------------------------------------------------------------------
# the write path, step by step
# ---------------------------------------------------------------------------

def _assert_states_equal(t_state, j_state, step):
    for name in ("size", "wm", "lm"):
        np.testing.assert_array_equal(_n(getattr(t_state, name)),
                                      np.asarray(getattr(j_state, name)),
                                      err_msg=f"{name} at step {step}")
    for name in ("k", "v", "count", "attn"):
        np.testing.assert_allclose(_n(getattr(t_state, name)),
                                   np.asarray(getattr(j_state, name)),
                                   rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} at step {step}")


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("long_mem_size", [64, 0])
def test_add_mem_check_step_by_step(batch, long_mem_size):
    """Reads and writes alternate for 18 frames: with long_mem_size=64,
    work_mem_size=2 and 16 tokens per frame the bank prunes every third
    write after the seventh (>= 3 prune cycles); some frames repeat an
    earlier one so dedup fires; long_mem_size=0 takes the sliding-window
    roll branch."""
    p, d, steps = 16, 32, 18
    jcfg = JMemoryConfig(long_mem_size=long_mem_size, work_mem_size=2)
    tcfg = MemoryConfig(long_mem_size=long_mem_size, work_mem_size=2)
    cap = jcfg.capacity(p)
    rng = np.random.default_rng(20 + batch)
    jn = {n: init_layer_norm(d) for n in ("norm_q", "norm_k", "norm_v")}
    tn = torch.nn.Module()
    for n in ("norm_q", "norm_k", "norm_v"):
        setattr(tn, n, torch.nn.LayerNorm(d, eps=1e-6))

    j_read = jax.jit(lambda s, q: JM.memory_read(jn, s, q, attn_thresh=5e-4))
    j_write = jax.jit(lambda s, k, v: JM.add_mem_check(s, k, v, jcfg))
    j_state = JM.init_memory(batch, cap, d, dtype=jnp.float32)
    t_state = TM.init_memory(batch, cap, d, dtype=torch.float32)
    history = []
    prunes = 0
    for step in range(steps):
        q = rng.standard_normal((batch, p, d)).astype(np.float32)
        if step % 5 == 4:        # repeat the previous frame: a duplicate
            fk, fv = history[-1]
        else:
            fk = rng.standard_normal((batch, p, d)).astype(np.float32)
            fv = rng.standard_normal((batch, p, d)).astype(np.float32)
        history.append((fk, fv))
        _, j_state = j_read(j_state, jnp.asarray(q))
        _, t_state = TM.memory_read(tn, t_state, torch.from_numpy(q),
                                    attn_thresh=5e-4)
        lm_before = np.asarray(j_state.lm).copy()
        j_state = j_write(j_state, jnp.asarray(fk), jnp.asarray(fv))
        t_state = TM.add_mem_check(t_state, torch.from_numpy(fk),
                                   torch.from_numpy(fv), tcfg)
        if long_mem_size and (np.asarray(j_state.lm) < lm_before).any():
            prunes += 1
        _assert_states_equal(t_state, j_state, step)
    if long_mem_size:
        assert prunes >= 3


def test_prune_tie_order():
    """Protected slots all weigh 1e8 and unprotected ones tie on equal
    attention/age: the kept order must be lax.top_k's (lower slot first)."""
    cap, d = 128, 8
    cfg_j = JMemoryConfig(long_mem_size=40, work_mem_size=2)
    cfg_t = MemoryConfig(long_mem_size=40, work_mem_size=2)
    rng = np.random.default_rng(30)
    k = rng.standard_normal((1, cap, d)).astype(np.float32)
    count = np.where(np.arange(cap) % 3 == 0, 2.0, 20.0).astype(np.float32)[None]
    attn = np.where(np.arange(cap) % 2 == 0, 4.0, 8.0).astype(np.float32)[None]
    size = np.array([100], np.int32)
    j_state = JM.MemoryState(jnp.asarray(k), jnp.asarray(k * 2), jnp.asarray(count),
                             jnp.asarray(attn), jnp.asarray(size),
                             jnp.asarray([2], jnp.int32), jnp.asarray([70], jnp.int32))
    t_state = memory_state_from_jax(_state_np(j_state))
    _assert_states_equal(TM.memory_prune(t_state, cfg_t),
                         JM.memory_prune(j_state, cfg_j), "prune")


def test_check_sim_vs_jax():
    p, d = 8, 16
    rng = np.random.default_rng(31)
    state = JM.init_memory(2, 64, d, dtype=jnp.float32)
    frames = [rng.standard_normal((2, p, d)).astype(np.float32) for _ in range(3)]
    for f in frames:
        state = JM.add_mem(state, jnp.asarray(f), jnp.asarray(f))
    state = state._replace(wm=jnp.asarray([2, 3], jnp.int32))
    probe = np.stack([frames[2][0], frames[0][1] + 0.5])   # dup / not a dup
    ref = JM.check_sim(state, jnp.asarray(probe), p, 3, 0.95)
    out = TM.check_sim(memory_state_from_jax(_state_np(state)),
                       torch.from_numpy(probe), p, 3, 0.95)
    np.testing.assert_array_equal(_n(out), np.asarray(ref))
    assert out.tolist() == [True, False]


def test_training_read_not_ported():
    """Reads with memory dropout are the training read's
    (`memory_read_train`, ported with training): the inference read takes
    no dropout, so asking it for dropout raises instead of silently reading
    without it, and the training read applies it."""
    _, tn = _norms(32)
    state = TM.init_memory(1, C, D, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    state = state._replace(k=torch.randn(1, C, D, generator=g),
                           v=torch.randn(1, C, D, generator=g),
                           size=torch.tensor([C // 2], dtype=torch.int32))
    q = torch.randn(1, P, D, generator=g)
    with pytest.raises(TypeError, match="dropout_rate"):
        TM.memory_read(tn, state, q, attn_thresh=0.0, dropout_rate=0.15)
    plain, _ = TM.memory_read_train(tn, state, q, dropout_rate=0.15)
    dropped, _ = TM.memory_read_train(tn, state, q, dropout_rate=0.15,
                                      generator=torch.Generator().manual_seed(1))
    assert not torch.equal(plain, dropped)
