"""The port's differentiable pieces against the JAX package, on the CPU:
the SDPA and RoPE gradients (and the autograd wiring of their kernels,
with the kernels' plain versions standing in), the training memory read
with and without dropout, the training criterion over its options, and
`forward_train` with the full loss's gradients.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances, fp32 throughout: single ops 1e-5 (sums in another order);
the memory read and the losses 1e-5 relative to the largest value; the
whole model's predictions 1e-4 and its gradients 1e-4 of the largest
|grad| (a dozen layers of fp32 sums in another order on each side).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spann3r_tpu import config as JC
from spann3r_tpu import losses as JL
from spann3r_tpu.models import memory as JMEM
from spann3r_tpu.models import spann3r as JS
from spann3r_tpu.ops import attention as JATT
from spann3r_tpu.ops import rope as JROPE
from spann3r_torch import config as TC
from spann3r_torch import losses as TL
from spann3r_torch.models import memory as TMEM
from spann3r_torch.models import spann3r as TS
from spann3r_torch.ops import _kernels, attention, rope
from spann3r_torch.utils.convert import (memory_state_from_jax,
                                         state_dict_from_jax_params)
from tests.test_torch_model import _cfg, _models

OP_TOL = 1e-5
MODEL_TOL = 1e-4


def _close(got, want, tol, scale=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(scale, 1e-6))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# SDPA and RoPE gradients
# ---------------------------------------------------------------------------

def _qkv(seed, n=37, m=29):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 3, n, 64)).astype(np.float32)
    k = rng.standard_normal((2, 3, m, 64)).astype(np.float32)
    v = rng.standard_normal((2, 3, m, 64)).astype(np.float32)
    w = rng.standard_normal((2, 3, n, 64)).astype(np.float32)
    return q, k, v, w


@pytest.mark.parametrize("n,m", [(37, 29), (64, 64)])
def test_sdpa_grads_match_jax(n, m):
    q, k, v, w = _qkv(0, n, m)
    want = jax.grad(lambda *a: jnp.sum(JATT._sdpa(*a, 0.125) * w),
                    argnums=(0, 1, 2))(q, k, v)
    leaves = [_t(x, True) for x in (q, k, v)]
    got = torch.autograd.grad((attention.sdpa(*leaves, 0.125) * _t(w)).sum(),
                              leaves)
    for g, ww in zip(got, want):
        _close(g, ww, OP_TOL)
    # the kernel's arithmetic in plain PyTorch gives the same gradients
    lse = torch.logsumexp(torch.matmul(leaves[0], leaves[1].transpose(-1, -2))
                          * 0.125, dim=-1).detach()
    plain = attention.sdpa_backward_plain(*(_t(x) for x in (q, k, v)), _t(w),
                                          lse, 0.125)
    for g, ww in zip(plain, want):
        _close(g, ww, OP_TOL)


def _rope_inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 3, 40, 64)).astype(np.float32)
    k = rng.standard_normal((2, 3, 40, 64)).astype(np.float32)
    pos = rng.integers(0, 32, (2, 40, 2)).astype(np.int32)
    wq = rng.standard_normal(q.shape).astype(np.float32)
    wk = rng.standard_normal(k.shape).astype(np.float32)
    return q, k, pos, wq, wk


def _jax_rope_grads(fn, q, k, pos, wq, wk):
    return jax.grad(lambda a, b: jnp.sum(fn(a, pos, 100.0) * wq)
                    + jnp.sum(fn(b, pos, 100.0) * wk), argnums=(0, 1))(q, k)


@pytest.mark.parametrize("jax_path", ["ref", "pallas_interpret"])
def test_rope_qk_grads_match_jax(jax_path, monkeypatch):
    """rope_2d_qk's gradients against jax.grad of rope_2d: its jnp
    reference, and the Pallas kernel (whose backward is the kernel at sign
    -1) in interpret mode, as tests/test_pallas_rope.py runs it."""
    import functools

    from jax.experimental import pallas as pl
    from spann3r_tpu.ops import pallas_rope

    q, k, pos, wq, wk = _rope_inputs(1)
    if jax_path == "ref":
        fn = JROPE.rope_2d_ref
    else:
        monkeypatch.setattr(pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
        fn = pallas_rope.rope_2d_pallas
    want = _jax_rope_grads(fn, q, k, pos, wq, wk)
    qt, kt = _t(q, True), _t(k, True)
    qr, kr = rope.rope_2d_qk(qt, kt, _t(pos), _t(pos), 100.0)
    got = torch.autograd.grad((qr * _t(wq)).sum() + (kr * _t(wk)).sum(),
                              (qt, kt))
    for g, ww in zip(got, want):
        _close(g, ww, OP_TOL)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The CUDA launches of the SDPA and RoPE wrappers replaced by their
    plain versions (counting as the wrappers do), so that the autograd
    Functions around the kernels run on CPU tensors."""
    def sdpa_cuda(q, k, v, scale, with_lse=False):
        _kernels.LAUNCHES["sdpa"] += 1
        out = attention.sdpa_plain(q, k, v, scale)
        lse = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(
            -1, -2)) * scale, dim=-1)
        return (out, lse) if with_lse else out

    def sdpa_backward_cuda(q, k, v, dout, lse, scale):
        _kernels.LAUNCHES["sdpa_bwd"] += 1
        return attention.sdpa_backward_plain(q, k, v, dout, lse, scale)

    def launch(ops, base, sign, tile=None, counter="rope2d"):
        _kernels.LAUNCHES[counter] += 1
        return [rope.rope_2d_plain(x, p, base, sign) for x, p in ops]

    monkeypatch.setattr(attention, "sdpa_cuda", sdpa_cuda)
    monkeypatch.setattr(attention, "sdpa_backward_cuda", sdpa_backward_cuda)
    monkeypatch.setattr(rope, "_launch", launch)
    _kernels.reset_launches()
    yield _kernels
    _kernels.reset_launches()


def test_kernel_autograd_functions(plain_kernels):
    """SDPAKernel and RopeKernel (the autograd Functions the card runs)
    give plain autograd's gradients: one forward and one backward launch
    each, the gradients through the backward at the opposite sign."""
    q, k, pos, wq, _ = _rope_inputs(2)
    v = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    results = []
    for use_fn in (True, False):
        qt, kt, vt = (_t(x, True) for x in (q, k, v))
        if use_fn:
            qr, kr = rope.RopeKernel.apply(100.0, 1.0, qt, _t(pos), kt, _t(pos))
            out = attention.SDPAKernel.apply(qr, kr, vt, 0.125)
        else:
            qr, kr = (rope.rope_2d_plain(x, _t(pos), 100.0) for x in (qt, kt))
            out = attention.sdpa_plain(qr, kr, vt, 0.125)
        results.append(torch.autograd.grad((out * _t(wq)).sum(), (qt, kt, vt)))
    for g, w in zip(*results):
        _close(g, w.detach().numpy(), OP_TOL)
    assert {k: v for k, v in plain_kernels.launch_counts().items() if v} == {
        "rope2d": 1, "sdpa": 1, "sdpa_bwd": 1, "rope2d_bwd": 1}


# ---------------------------------------------------------------------------
# the training memory read
# ---------------------------------------------------------------------------

def _read_inputs(seed, rate):
    jcfg, tcfg, params, params_np, model = _models("dpt")
    rng = np.random.default_rng(seed)
    b, p, d, c = 2, 16, jcfg.attn_head_out, 48
    state = JMEM.init_memory(b, c, d, dtype=jnp.float32)
    state = state._replace(
        k=jnp.asarray(rng.standard_normal((b, c, d)), jnp.float32),
        v=jnp.asarray(rng.standard_normal((b, c, d)), jnp.float32),
        size=jnp.asarray([32, 0], jnp.int32))   # one empty bank
    feat = rng.standard_normal((b, p, d)).astype(np.float32)
    norms = {n: params[n] for n in ("norm_q", "norm_k", "norm_v")}
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    return jcfg, model, state, feat, norms, key


@pytest.mark.parametrize("rate", [0.0, 0.15])
def test_training_read_matches_jax(rate):
    """The training read against JAX's XLA read (attn_thresh 0): values and
    the gradients to the features and to the bank. With dropout, JAX's
    keep mask for the step's key is drawn and handed to the port."""
    jcfg, model, state, feat, norms, key = _read_inputs(4, rate)
    w = np.random.default_rng(5).standard_normal(feat.shape).astype(np.float32)

    def jread(f, k, v):
        s = state._replace(k=k, v=v)
        out, s2 = JMEM.memory_read(norms, s, f, attn_thresh=0.0,
                                   dropout_rng=key if rate else None,
                                   dropout_rate=rate)
        return jnp.sum(out * w), (out, s2.attn)

    (_, (want, want_attn)), want_g = jax.value_and_grad(
        jread, argnums=(0, 1, 2), has_aux=True)(feat, state.k, state.v)
    keep = None
    if rate:
        keep = _t(np.asarray(jax.random.bernoulli(
            key, 1.0 - rate, (2, feat.shape[1], state.k.shape[1]))))
    tstate = memory_state_from_jax(state)
    f, k, v = _t(feat, True), tstate.k.requires_grad_(True), \
        tstate.v.requires_grad_(True)
    out, s2 = TMEM.memory_read_train(model, tstate._replace(k=k, v=v), f,
                                     attn_thresh=0.0, dropout_rate=rate,
                                     keep=keep)
    got_g = torch.autograd.grad((out * _t(w)).sum(), (f, k, v))
    _close(out, want, OP_TOL)
    _close(s2.attn, want_attn, OP_TOL)
    np.testing.assert_array_equal(out[1].detach().numpy(), feat[1])  # empty
    for g, ww in zip(got_g, want_g):
        _close(g, ww, OP_TOL)


def test_training_read_dropout_statistics():
    """Dropout from a torch.Generator keeps each weight with probability
    1 - rate (the mean kept share within 5 sigma of a binomial over the
    draws), scales the kept ones by 1 / (1 - rate), and repeats with the
    same seed; without a generator it is off."""
    _, model, state, feat, _, _ = _read_inputs(6, 0.15)
    tstate = memory_state_from_jax(state)
    f = _t(feat)
    ref, _ = TMEM.memory_read_train(model, tstate, f, dropout_rate=0.0)
    off, _ = TMEM.memory_read_train(model, tstate, f, dropout_rate=0.15)
    assert torch.equal(off, ref)
    runs = [TMEM.memory_read_train(model, tstate, f, dropout_rate=0.15,
                                   generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert not torch.equal(runs[0][0], ref)
    # the kept share: the attention statistic sums the dropped-and-scaled
    # weights; over the 32 valid slots of stream 0 its total is the kept
    # share of 16 rows of unit mass, scaled by 1 / 0.85
    g = torch.Generator().manual_seed(10)
    shares = []
    for _ in range(20):
        _, s = TMEM.memory_read_train(model, tstate, f, dropout_rate=0.15,
                                      generator=g)
        shares.append(float(s.attn[0].sum()) * 0.85 / feat.shape[1])
    n = 20 * feat.shape[1] * 32
    mean = float(np.mean(shares))
    assert abs(mean - 0.85) < 5 * math.sqrt(0.85 * 0.15 / n) + 0.05


def test_append_carries_autograd():
    """add_mem writes the new tokens by index; their gradients flow back
    through the bank to a later read."""
    _, model, state, feat, _, _ = _read_inputs(7, 0.0)
    tstate = memory_state_from_jax(state)
    fk = _t(feat[:, :8], True)
    s = TMEM.add_mem(tstate, fk, fk * 2.0)
    out, _ = TMEM.memory_read_train(model, s, _t(feat))
    (g,) = torch.autograd.grad(out.sum(), (fk,))
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    assert int(s.size[1]) == 8 and int(s.size[0]) == 40


# ---------------------------------------------------------------------------
# the training criterion
# ---------------------------------------------------------------------------

def _loss_inputs(seed, t=3, b=2, h=8, w=8):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-0.3, 0.3, (t, b))
    pose = np.broadcast_to(np.eye(4, dtype=np.float32), (t, b, 4, 4)).copy()
    pose[..., 0, 0] = pose[..., 1, 1] = np.cos(ang)
    pose[..., 0, 1], pose[..., 1, 0] = -np.sin(ang), np.sin(ang)
    pose[..., :3, 3] = rng.standard_normal((t, b, 3))
    gts = {"pts3d": (rng.standard_normal((t, b, h, w, 3)) * 2 + 3).astype(np.float32),
           "valid_mask": rng.random((t, b, h, w)) > 0.3,
           "camera_pose": pose}
    gts["valid_mask"][1, 1] = False        # a frame with no valid pixel
    preds = {"pts3d_1": (rng.standard_normal((t - 1, b, h, w, 3)) + 1).astype(np.float32),
             "pts3d_2": (rng.standard_normal((t - 1, b, h, w, 3)) + 1).astype(np.float32),
             "conf_1": (1 + rng.random((t - 1, b, h, w))).astype(np.float32),
             "conf_2": (1 + rng.random((t - 1, b, h, w))).astype(np.float32)}
    return gts, preds


GRID = [dict(norm_mode=nm, fix_first=ff, dist_clip=dc)
        for nm in (True, False) for ff in (False, True) for dc in (None, 4.5)]


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_conf_loss_matches_jax(kw):
    """conf_loss_t (with regr3d_t_frame_losses and get_all_pts3d_t under
    it) over the norm_mode / fix_first / dist_clip grid: the loss, the
    details, the scale penalty and the gradients to the predictions."""
    gts, preds = _loss_inputs(11)

    def jloss(p):
        loss, details, factor = JL.conf_loss_t(
            {k: jnp.asarray(v) for k, v in gts.items()}, p, alpha=0.3, **kw)
        return loss + factor, (loss, details, factor)

    (_, (jl, jd, jf)), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = {k: _t(v, True) for k, v in preds.items()}
    tl, td, tf = TL.conf_loss_t({k: _t(v) for k, v in gts.items()}, tp,
                                alpha=0.3, **kw)
    tg = torch.autograd.grad(tl + tf, list(tp.values()))
    _close(tl, jl, OP_TOL)
    _close(tf, jf, OP_TOL, scale=1.0)
    assert set(td) == set(jd)
    for k in jd:
        _close(td[k], jd[k], OP_TOL)
    for (k, g) in zip(tp, tg):
        _close(g, jg[k], OP_TOL)


@pytest.mark.parametrize("kw", [dict(norm_mode=True, fix_first=True,
                                     dist_clip=4.5),
                                dict(norm_mode=False, gt_scale=True,
                                     shift_inv=True, scale_inv=True),
                                dict(norm_mode=True, shift_inv=True,
                                     scale_inv=True)])
def test_get_all_pts3d_matches_jax(kw):
    gts, preds = _loss_inputs(12)
    want = JL.get_all_pts3d_t({k: jnp.asarray(v) for k, v in gts.items()},
                              {k: jnp.asarray(v) for k, v in preds.items()},
                              **kw)
    got = TL.get_all_pts3d_t({k: _t(v) for k, v in gts.items()},
                             {k: _t(v) for k, v in preds.items()}, **kw)
    for i in (0, 1, 2, 5):                 # gt, pr_l, pr_r, valids
        for a, b in zip(got[i], want[i]):
            _close(a, b, OP_TOL)
    for i in (3, 4):                       # the factors
        assert (got[i] is None) == (want[i] is None)
        if got[i] is not None:
            _close(got[i], want[i], OP_TOL)
    assert set(got[6]) == set(want[6])
    for k in want[6]:
        _close(got[6][k], want[6][k], OP_TOL)


# ---------------------------------------------------------------------------
# forward_train and the full loss's gradients
# ---------------------------------------------------------------------------

def _train_batch(seed, hw, t=3, b=2):
    rng = np.random.default_rng(seed)
    return {"img": (rng.standard_normal((t, b, *hw, 3)) * 0.3).astype(np.float32),
            "pts3d": (rng.standard_normal((t, b, *hw, 3)) + 2.0).astype(np.float32),
            "valid_mask": rng.random((t, b, *hw)) > 0.2,
            "camera_pose": np.broadcast_to(np.eye(4, dtype=np.float32),
                                           (t, b, 4, 4)).copy()}


def jax_loss_fn(jcfg, batch, prec=JC.FP32):
    def loss(p):
        frames = jnp.transpose(jnp.asarray(batch["img"]), (1, 0, 2, 3, 4))
        preds = JS.forward_train(p, frames, jcfg, prec, rng=None, remat=False)
        gts = {k: jnp.asarray(batch[k])
               for k in ("pts3d", "valid_mask", "camera_pose")}
        l, d, f = JL.conf_loss_t(gts, preds, alpha=0.4, norm_mode=True)
        return l + f
    return loss


def test_forward_train_and_grads_match_jax(kind="dpt"):
    """forward_train's stacked predictions on the same weights and frames,
    and the gradients of conf_loss_t + the scale penalty against jax.grad,
    mapped to the port's names through state_dict_from_jax_params (the
    gradients share the parameters' tree)."""
    from spann3r_torch import training as TT

    jcfg, tcfg, params, params_np, model = _models(kind)
    hw = tcfg.dust3r.img_size
    batch = _train_batch(13, hw)
    frames = np.transpose(batch["img"], (1, 0, 2, 3, 4))
    want = JS.forward_train(params, jnp.asarray(frames), jcfg, JC.FP32,
                            rng=None, remat=False)
    with torch.no_grad():
        got = TS.forward_train(model, _t(frames), tcfg, TC.FP32)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        _close(got[k], want[k], MODEL_TOL)

    jl, jg = jax.value_and_grad(jax_loss_fn(jcfg, batch))(params)
    loss, _, grads = TT.value_and_grad(model, tcfg, TC.FP32,
                                       TT.batch_to_device(batch, "cpu"), None,
                                       0.4)
    _close(loss, jl, MODEL_TOL)
    want_g = state_dict_from_jax_params(jax.tree.map(np.asarray, jg), tcfg)
    assert set(grads) == set(want_g)
    gmax = max(float(v.abs().max()) for v in want_g.values())
    for name, g in grads.items():
        _close(g, want_g[name].numpy(), MODEL_TOL, scale=gmax)
