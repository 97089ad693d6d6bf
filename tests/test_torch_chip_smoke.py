"""The checks of chip_smoke.py, on the CPU at small shapes: the bound that
holds each kernel against its plain version passes a result that differs
by one bf16 rounding and rejects the planted faults the script runs on the
card; the script refuses to run without a card."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from spann3r_torch.ops import attention, memory_read, rope  # noqa: E402


def _randn(*shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def test_bound_passes_one_bf16_rounding():
    want = _randn(2, 64, 128, seed=0) * 0.05
    ok, max_abs, _, n_over = chip_smoke.compare(
        "x", want.to(torch.bfloat16), want, chip_smoke.TOL_BF16)
    assert ok and n_over == 0 and 0 < max_abs < 1e-3


def _rope_operands():
    qkv = _randn(2, 40, 3, 4, 64, seed=10).to(torch.bfloat16).permute(2, 0, 3, 1, 4)
    pos = torch.randint(0, 32, (40, 2), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(11))
    return qkv[1], pos[None].expand(2, -1, -1)


def test_rope_bound_passes_one_bf16_rounding():
    """The K3 bound 8e-3 * (rms + |plain|) holds the rounding of the fp32
    result and a neighbour one bf16 ulp away, the most two sides that round
    once can differ by."""
    k, pos = _rope_operands()
    exact = rope.rope_2d_plain(k.float(), pos, 100.0)
    want = exact.to(torch.bfloat16)
    assert chip_smoke.compare("rope2d", want, exact, chip_smoke.TOL_ROPE_BF16)[0]
    up = (want.view(torch.int16) + 1).view(torch.bfloat16)   # one ulp away
    assert (up != want).all()
    ok, max_abs, _, n_over = chip_smoke.compare(
        "rope2d", up, want, chip_smoke.TOL_ROPE_BF16)
    assert ok and n_over == 0 and max_abs > 0


def test_rope_bound_rejects_an_unrotated_head():
    """The planted K3 fault: the last head of k left unrotated."""
    k, pos = _rope_operands()
    want = rope.rope_2d_plain(k, pos, 100.0)
    wrong = want.clone()
    wrong[:, -1] = k[:, -1]
    ok, _, _, n_over = chip_smoke.compare("rope2d", wrong, want,
                                          chip_smoke.TOL_ROPE_BF16)
    assert not ok and n_over > 0
    assert chip_smoke.compare("rope2d", want, want, chip_smoke.TOL_ROPE_BF16)[0]


def test_bound_rejects_a_missing_key_tile():
    q, k, v = (_randn(1, 2, 128, 64, seed=s).to(torch.bfloat16)
               for s in (1, 2, 3))
    want = attention.sdpa_plain(q, k, v, 0.125)
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2))
                      * 0.125, dim=-1).to(torch.bfloat16).float()
    assert chip_smoke.compare("sdpa", want, want, chip_smoke.TOL_BF16)[0]
    p[..., -64:] = 0.0
    wrong = torch.matmul(p, v.float()).to(torch.bfloat16)
    assert not chip_smoke.compare("sdpa", wrong, want, chip_smoke.TOL_BF16)[0]


@pytest.mark.parametrize("out", ["dq", "dv"])
def test_bound_rejects_a_backward_without_its_last_tile(out):
    """The planted K2-backward faults in dq (the last key tile's terms left
    out) and dv (the last query tile's), at a ragged 196 tokens: rejected,
    while the plain result passes against itself."""
    qkv = _randn(2, 196, 3, 2, 64, seed=7).to(torch.bfloat16).permute(
        2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    dout = _randn(2, 196, 2, 64, seed=8).to(torch.bfloat16).transpose(1, 2)
    lse = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2))
                          * 0.125, dim=-1)
    want = attention.sdpa_backward_plain(q, k, v, dout, lse, 0.125)
    wrong_dq, wrong_dv = chip_smoke.sdpa_bwd_without_tails(q, k, v, dout,
                                                           lse, 0.125)
    i, wrong = (0, wrong_dq) if out == "dq" else (2, wrong_dv)
    assert wrong.dtype == torch.bfloat16 and wrong.shape == want[i].shape
    assert chip_smoke.compare("sdpa_bwd", want[i], want[i],
                              chip_smoke.TOL_BF16)[0]
    ok, _, _, n_over = chip_smoke.compare("sdpa_bwd", wrong, want[i],
                                          chip_smoke.TOL_BF16)
    assert not ok and n_over > 0


def _peaked_backward_operands(seed, b=2, h=4, n=196):
    """bf16 q, k, v, dO at (b, h, n, 64), q three times the others (peaked
    softmax rows, as a trained model's), and the fp32 logsumexp."""
    qkv = _randn(b, n, 3, h, 64, seed=seed).permute(2, 0, 3, 1, 4)
    q = (qkv[0] * 3).to(torch.bfloat16)
    k, v = qkv[1].to(torch.bfloat16), qkv[2].to(torch.bfloat16)
    dout = _randn(b, n, h, 64, seed=seed + 1).to(torch.bfloat16).transpose(
        1, 2)
    lse = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2))
                          * 0.125, dim=-1)
    return q, k, v, dout, lse


def test_flip_allowance_covers_the_other_rounding():
    """A backward whose every P and dS entry within rounding of a bf16
    boundary rounds the other way from sdpa_backward_plain's: its outputs
    move, and stay within the bound with the flip term added; fp32 gets no
    term. (Past the plain bound alone such a flip showed once in 38.5
    million elements on the card, at (64,16,196,196); this shape is too
    small to show it.)"""
    q, k, v, dout, lse = _peaked_backward_operands(7)
    want = attention.sdpa_backward_plain(q, k, v, dout, lse, 0.125)
    flip, flipped = chip_smoke.bwd_flip_allowance(q, k, v, dout, lse, 0.125)
    p, w_p, ds, w_ds = chip_smoke.bwd_rounding_intervals(q, k, v, dout, lse,
                                                         0.125)

    def other(x, w):
        lo, hi = ((x + sign * w).to(torch.bfloat16) for sign in (-1, 1))
        return torch.where(x.to(torch.bfloat16) == lo, hi, lo).float()

    ds_o, p_o = other(ds, w_ds), other(p, w_p)
    got = (torch.matmul(ds_o, k.float()),
           torch.matmul(ds_o.transpose(-1, -2), q.float()),
           torch.matmul(p_o.transpose(-1, -2), dout.float()))
    assert flipped > 0
    for i in range(3):
        g = got[i].to(torch.bfloat16)
        assert not torch.equal(g, want[i])
        assert chip_smoke.compare("sdpa_bwd", g, want[i], chip_smoke.TOL_BF16,
                                  flip[i])[0]
    assert chip_smoke.bwd_flip_allowance(
        q.float(), k.float(), v.float(), dout.float(), lse, 0.125) == (
        (0.0, 0.0, 0.0), 0)


def test_flip_allowance_keeps_the_planted_faults():
    """With the flip term the planted K2-backward faults (dq and dv without
    their last tile's terms, dk without its last key tile) are still
    rejected, on peaked rows at 196 tokens."""
    q, k, v, dout, lse = _peaked_backward_operands(9)
    want = attention.sdpa_backward_plain(q, k, v, dout, lse, 0.125)
    flip, _ = chip_smoke.bwd_flip_allowance(q, k, v, dout, lse, 0.125)
    wrong_dq, wrong_dv = chip_smoke.sdpa_bwd_without_tails(q, k, v, dout,
                                                           lse, 0.125)
    wrong_dk = want[1].clone()
    wrong_dk[..., -64:, :] = 0.0
    for i, wrong in enumerate((wrong_dq, wrong_dk, wrong_dv)):
        assert chip_smoke.compare("sdpa_bwd", want[i], want[i],
                                  chip_smoke.TOL_BF16, flip[i])[0]
        assert not chip_smoke.compare("sdpa_bwd", wrong, want[i],
                                      chip_smoke.TOL_BF16, flip[i])[0]


@pytest.mark.parametrize("thr", [0.0, 5e-3])
def test_bound_rejects_a_missing_slot_range(thr):
    q, k, v = (_randn(1, n, 64, seed=s).to(torch.bfloat16)
               for s, n in ((4, 48), (5, 256), (6, 256)))
    sizes = (256,)
    size = torch.tensor(sizes, dtype=torch.int32)
    want = memory_read.memory_read_attention_plain(q, k, v, size, thr)
    extra = (0.0, 0.0)
    if thr > 0:
        extra, term, rows = chip_smoke.flip_allowance(q, k, v, sizes, thr)
        assert term > 0 and 0 <= rows < q.shape[1]
    for got, ref, ex in zip(want, want, extra):
        assert chip_smoke.compare("mem", got, ref, chip_smoke.TOL_BF16, ex)[0]
    a, _, _ = chip_smoke.plain_weights(q, k, sizes, thr)
    torch.testing.assert_close(torch.matmul(a, v.float()).to(q.dtype), want[0])
    torch.testing.assert_close(a.sum(-2), want[1])
    a[..., :64] = 0.0
    wrong = torch.matmul(a, v.float()).to(q.dtype)
    assert not chip_smoke.compare("mem", wrong, want[0], chip_smoke.TOL_BF16,
                                  extra[0])[0]


def test_flip_allowance_covers_only_rows_near_the_threshold():
    q, k, v = (_randn(2, n, 32, seed=s) for s, n in ((7, 40), (8, 96), (9, 96)))
    thr = 1.0 / 96
    (ex_out, ex_asum), term, rows = chip_smoke.flip_allowance(
        q, k, v, (96, 50), thr)
    assert ex_out.shape == (2, 40, 1) and ex_asum.shape == (2, 96)
    assert set(ex_out.unique().tolist()) <= {0.0, term}
    assert rows == int((ex_out > 0).sum())
    assert not ex_asum[1, 50:].any()   # no weight past a stream's size


def test_flip_allowance_covers_the_renormalisation_of_a_flipped_row():
    """A weight exactly at the threshold, kept by one side and dropped by
    the other: the column sums of the whole row move (its renormalisation),
    not only the flipped slot's, and the fp32 bound with the allowance
    holds them."""
    q, k, v = (_randn(1, n, 32, seed=s) for s, n in ((12, 8), (13, 64), (14, 64)))
    s = torch.matmul(q[0], k[0].T) / 32 ** 0.5
    a_pre = torch.softmax(s, -1)
    c0 = int(a_pre[0].argsort()[40])             # a weight above the mean
    thr = float(a_pre[0, c0])
    size = torch.tensor([64], dtype=torch.int32)
    _, want = memory_read.memory_read_attention_plain(q, k, v, size, thr)
    a = torch.where(a_pre < thr, torch.zeros_like(a_pre), a_pre)
    a[0, c0] = 0.0                               # the other side drops it
    flipped = (a / (a.sum(-1, keepdim=True) + 1e-12)).sum(0, keepdim=True)
    tol = chip_smoke.TOL[("memory_read", torch.float32)]
    (_, ex_asum), term, rows = chip_smoke.flip_allowance(q, k, v, (64,), thr)
    assert rows >= 1
    assert chip_smoke.compare("asum", flipped, want, tol, ex_asum)[0]
    # the flipped slot's term alone does not hold the rest of the row
    near_only = (ex_asum >= term).float() * term
    assert not chip_smoke.compare("asum", flipped, want, tol, near_only)[0]


def test_script_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.fixture
def counting_kernels(monkeypatch):
    """The kernel wrappers' CUDA entry points as counting plain versions
    that CPU tensors reach, so that a CPU run counts launches as the card
    would and chip_smoke's ShapeTally sees them."""
    from spann3r_torch.models import memory as TM
    from spann3r_torch.ops import _kernels

    def sdpa_cuda(q, k, v, scale):
        _kernels.LAUNCHES["sdpa"] += 1
        return attention.sdpa_plain(q, k, v, scale)

    def launch(ops, base, sign, tile=None):
        _kernels.LAUNCHES["rope2d"] += 1
        return [rope.rope_2d_plain(x, p, base, sign) for x, p in ops]

    def read(*a):
        _kernels.LAUNCHES["memory_read"] += 1
        return memory_read.memory_read_attention_plain(*a)

    monkeypatch.setattr(attention, "sdpa_cuda", sdpa_cuda)
    monkeypatch.setattr(attention, "sdpa",
                        lambda q, k, v, s: attention.sdpa_cuda(q, k, v, s))
    monkeypatch.setattr(rope, "_launch", launch)
    monkeypatch.setattr(attention, "rope_2d_qk",
                        lambda q, k, qp, kp, base=100.0, sign=1.0:
                        tuple(rope._launch([(q, qp), (k, kp)], base, sign)))
    monkeypatch.setattr(TM, "memory_read_attention", read)
    _kernels.reset_launches()
    yield _kernels
    _kernels.reset_launches()


@pytest.mark.parametrize("n,graph", [(5, "complete"), (6, "swin-2"),
                                     (2, "complete")])
def test_offline_launch_counts(counting_kernels, n, graph):
    """chip_smoke's offline launch counts (offline_launches) are what an
    offline run launches, stage by stage: a tiny model whose decoders have
    their own head count, a last pairwise chunk that is short (swin-2), and
    the two-frame clip with no greedy round."""
    from spann3r_torch import config as C
    from spann3r_torch.models import offline, pairs
    from spann3r_torch.models import spann3r as S

    cfg = C.Spann3RConfig(
        dust3r=C.DUSt3RConfig(img_size=(32, 32), patch_size=16,
                              enc=C.ViTConfig(dim=64, depth=2, num_heads=4),
                              dec=C.ViTConfig(dim=48, depth=3, num_heads=2),
                              head_type="linear"),
        value_enc_depth=2, value_enc_dim=64, value_enc_heads=4,
        attn_head_in=64 + 48, attn_head_out=64)
    model = S.build_spann3r(cfg, "cpu", torch.Generator().manual_seed(0))
    frames = _randn(n, 32, 32, 3, seed=20) * 0.3
    wrappers = (rope._launch, attention.sdpa_cuda)
    with chip_smoke.ShapeTally() as tally:
        _, _, order = offline.offline_reconstruction(model, frames, cfg,
                                                     (32, 32), graph)
    assert sorted(order) == list(range(n))
    want = chip_smoke.offline_launches(cfg, n, len(pairs.make_pairs(n, graph)))
    counts = counting_kernels.launch_counts()
    assert counts["memory_read"] == want["memory_read"] == n - 2
    for k in ("rope2d", "sdpa"):
        assert tally.by_stage(k, cfg, n) == want[k]
        assert counts[k] == sum(want[k].values())
    assert want["rope2d"]["value encoder"] == 0 < want["sdpa"]["value encoder"]
    assert (rope._launch, attention.sdpa_cuda) == wrappers  # undone on exit


# ---------------------------------------------------------------------------
# the entry phase's helpers
# ---------------------------------------------------------------------------

def test_boxroom_batch_is_a_collated_scene():
    """The batch the entry phase renders where the host lacks PIL or cv2:
    the collated layout of a one-scene eval batch, images in [-1, 1], and
    world points that lie at the rendered depth in front of each camera."""
    import numpy as np

    b = chip_smoke.boxroom_batch(3, (32, 48), seed=5)
    assert set(b) == {"img", "pts3d", "valid_mask", "camera_pose"}
    assert b["img"].shape == b["pts3d"].shape == (3, 1, 32, 48, 3)
    assert b["valid_mask"].shape == (3, 1, 32, 48) and b["valid_mask"].all()
    assert b["camera_pose"].shape == (3, 1, 4, 4)
    assert b["img"].dtype == b["pts3d"].dtype == np.float32
    assert -1.0 <= b["img"].min() and b["img"].max() <= 1.0
    for t in range(3):
        pose = b["camera_pose"][t, 0]
        cam = (b["pts3d"][t, 0] - pose[:3, 3]) @ pose[:3, :3]
        assert (cam[..., 2] > 0).all()
    assert not np.array_equal(b["img"][0], b["img"][2])   # the camera moves
    again = chip_smoke.boxroom_batch(3, (32, 48), seed=5)
    for k in b:
        np.testing.assert_array_equal(b[k], again[k])


def _line(**kw):
    line = {k: 1 for k in chip_smoke.BENCH_KEYS}
    line.update(value=20.5, mfu_pct=2.3, tf32={"matmul": False, "conv": False})
    line.update(kw)
    return line


def test_bench_line_check():
    """The bench's line: bench.py's keys and the card's name, FPS > 0 and
    0 < mfu_pct < 100 (the port's bench returns these keys,
    tests/test_torch_entry.py)."""
    from tests.test_torch_entry import STREAM_KEYS

    assert chip_smoke.BENCH_KEYS == STREAM_KEYS
    chip_smoke.check_bench_line(_line())
    for bad in (_line(mfu_pct=None), _line(mfu_pct=0.0), _line(mfu_pct=150.0),
                _line(value=0.0), _line(chunk_fps=[1.0]),
                _line(tf32={"matmul": True, "conv": False})):
        with pytest.raises(AssertionError):
            chip_smoke.check_bench_line(bad)
    line = _line()
    del line["device"]
    with pytest.raises(AssertionError, match="keys"):
        chip_smoke.check_bench_line(line)


def test_missing_host_packages(monkeypatch):
    import importlib.util

    assert chip_smoke.missing_host_packages() == []    # both present here
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "cv2" else real(name, *a))
    assert chip_smoke.missing_host_packages() == ["cv2"]


# ---------------------------------------------------------------------------
# the training phase's launch counts
# ---------------------------------------------------------------------------

@pytest.fixture
def autograd_kernels(monkeypatch):
    """The card's dispatch of sdpa and rope_2d_qk on CPU tensors: under
    autograd through their autograd Functions (forward and backward
    launches counted), with the kernels' plain versions in the launches."""
    from spann3r_torch.ops import _kernels

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

    def grad(*ts):
        return torch.is_grad_enabled() and any(t.requires_grad for t in ts)

    monkeypatch.setattr(attention, "sdpa_cuda", sdpa_cuda)
    monkeypatch.setattr(attention, "sdpa_backward_cuda", sdpa_backward_cuda)
    monkeypatch.setattr(rope, "_launch", launch)
    monkeypatch.setattr(attention, "sdpa", lambda q, k, v, s: (
        attention.SDPAKernel.apply(q, k, v, s) if grad(q, k, v)
        else attention.sdpa_cuda(q, k, v, s)))
    monkeypatch.setattr(attention, "rope_2d_qk", lambda q, k, qp, kp, base=100.0,
                        sign=1.0: (rope.RopeKernel.apply(base, sign, q, qp, k, kp)
                                   if grad(q, k) else
                                   tuple(rope._launch([(q, qp), (k, kp)], base,
                                                      sign))))
    _kernels.reset_launches()
    yield _kernels
    _kernels.reset_launches()


@pytest.mark.parametrize("mem_pos_enc", [False, True])
def test_train_launch_counts(autograd_kernels, mem_pos_enc):
    """chip_smoke's train_launches is what one train step launches: each
    kernel's forward and backward (none in the last pair's value encoder,
    whose output nothing reads), no memory-read kernel; with mem_pos_enc
    the value encoder rotates too."""
    import dataclasses

    import numpy as np

    from spann3r_torch import config as C
    from spann3r_torch import training
    from spann3r_torch.models import spann3r as S

    cfg = C.Spann3RConfig(
        dust3r=C.DUSt3RConfig(img_size=(32, 32), patch_size=16,
                              enc=C.ViTConfig(dim=64, depth=2, num_heads=4),
                              dec=C.ViTConfig(dim=48, depth=3, num_heads=2),
                              head_type="linear"),
        value_enc_depth=2, value_enc_dim=64, value_enc_heads=4,
        attn_head_in=64 + 48, attn_head_out=64, mem_pos_enc=mem_pos_enc)
    if mem_pos_enc:   # value tokens from the decoder: dim 48
        cfg = dataclasses.replace(cfg, use_feat=True, value_enc_dim=48,
                                  value_enc_heads=2)
    model = S.build_spann3r(cfg, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    t, b = 4, 2
    batch = {"img": (rng.standard_normal((t, b, 32, 32, 3)) * 0.3).astype(np.float32),
             "pts3d": (rng.standard_normal((t, b, 32, 32, 3)) + 2).astype(np.float32),
             "valid_mask": np.ones((t, b, 32, 32), bool),
             "camera_pose": np.broadcast_to(np.eye(4, dtype=np.float32),
                                            (t, b, 4, 4)).copy()}
    opt = training.make_optimizer(0.05)
    step = training.make_train_step(cfg, C.FP32, opt)
    _, m = step(model, opt.init(dict(model.named_parameters())), batch,
                torch.Generator().manual_seed(1), 1e-4, 0.4)
    assert torch.isfinite(m["loss"])
    want = chip_smoke.train_launches(cfg, t)
    assert autograd_kernels.launch_counts() == want
    assert want["sdpa_bwd"] == want["sdpa"] - 2
    assert (want["rope2d"] == want["sdpa"]) == mem_pos_enc


def test_parity_train_config_runs_the_kernels():
    """The train-step parity's narrow configuration has head dim 64 in
    every stack, so that the card runs K2 there."""
    cfg = chip_smoke.parity_train_cfg()
    assert cfg.dust3r.enc.head_dim == cfg.dust3r.dec.head_dim == 64
    assert cfg.value_enc_dim // cfg.value_enc_heads == 64
    assert cfg.dust3r.img_size == chip_smoke.HW_224


# ---------------------------------------------------------------------------
# phase 12's helpers
# ---------------------------------------------------------------------------

def test_rank_parts_rebuild_the_uneven_global_batch():
    """The global batch of phase 12 (b): each clip keeps its own share of
    valid pixels, so the two ranks hold different valid counts; the ranks'
    parts, in rank order, are the global batch."""
    import numpy as np

    batch = chip_smoke.uneven_batch(3, 2, (32, 32), chip_smoke.DIST_KEEP, 7)
    parts = [chip_smoke.rank_part(batch, r, 2) for r in range(2)]
    for k, v in batch.items():
        assert parts[0][k].shape[1] == 1
        np.testing.assert_array_equal(
            np.concatenate([p[k] for p in parts], axis=1), v)
    shares = [p["valid_mask"].mean() for p in parts]
    for got, want in zip(shares, chip_smoke.DIST_KEEP):
        assert abs(got - want) < 0.02
    assert chip_smoke.rank_part(batch, 0, 1)["img"] is not None


def test_dist_fault_is_rejected():
    """grads_agree passes the reference against itself and a difference
    well inside DIST_TOL, and rejects gradients averaged over two ranks
    where they must be summed."""
    g = {"a": _randn(8, 8, seed=20), "b": _randn(16, seed=21)}
    gmax = max(float(v.abs().max()) for v in g.values())
    assert chip_smoke.grads_agree(3.0, g, 3.0, g, gmax)[0]
    near = {k: v + 1e-7 * gmax for k, v in g.items()}
    assert chip_smoke.grads_agree(3.0 * (1 + 1e-7), near, 3.0, g, gmax)[0]
    avg = {k: v / 2 for k, v in g.items()}
    ok, dl, dg = chip_smoke.grads_agree(3.0, avg, 3.0, g, gmax)
    assert not ok and dl == 0 and dg > 0.1
    assert not chip_smoke.grads_agree(3.1, g, 3.0, g, gmax)[0]


def test_state_bytes_prediction():
    """fp32 master and two moments a parameter; a sliced one as ceil(numel
    / n) elements a rank. The published configuration at 224 with bf16
    moments: 658,691,208 parameters, ~4.9 GiB in one process; --fsdp 1 at
    world 2 (the rule at --tp_min_dim 1024: input dim >= 1024, which leaves
    the decoders' 768-wide qkv, projections and fc1 whole) slices 67.7% of
    them, and holds half of that share a rank."""
    from spann3r_torch import config as C
    from spann3r_torch.models import spann3r as S
    from spann3r_torch.parallel import sharding

    shapes = {"w": (3, 5), "b": (5,)}
    assert chip_smoke.state_bytes(shapes, set(), 2, 2) == 20 * 8
    assert chip_smoke.state_bytes(shapes, {"w"}, 2, 4) == (8 + 5) * 12
    with torch.device("meta"):
        model = S.Spann3R(C.Spann3RConfig(
            dust3r=C.DUSt3RConfig(img_size=(224, 224), head_type="dpt")))
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert sum(int(torch.Size(s).numel()) for s in full.values()) == 658691208
    one = chip_smoke.state_bytes(full, set(), 1, 2)
    assert one == 658691208 * 8 and 4.9 < one / 2**30 < 4.91
    mesh = type("M", (), {"model": 1, "data": 2, "model_rank": 0,
                          "data_rank": 0, "model_group": None})()
    layout = sharding.Layout(model, C.Spann3RConfig(
        dust3r=C.DUSt3RConfig(img_size=(224, 224), head_type="dpt")),
        mesh, fsdp=True)
    sliced = set(layout.fsdp)
    two = chip_smoke.state_bytes(full, sliced, 2, 2)
    share = sum(int(torch.Size(full[n]).numel()) for n in sliced) / 658691208
    assert 0.67 < share < 0.68
    assert abs((one - two) - share * one / 2) < 1e6


# ---------------------------------------------------------------------------
# phase 13's launch counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", ["cosine", "RoPE100"])
def test_pretrain_launch_counts(autograd_kernels, pos):
    """chip_smoke's pretrain_launches is what one pretrain step launches:
    K2 both ways in each attention of the two encoder passes and of the
    decoder (self and cross), K3 both ways with RoPE100 only, no K1; at
    narrow widths of both published configurations' kinds (a head-dim-32
    decoder in the cosine one, as CroCoNet()'s)."""
    from spann3r_torch import config as C
    from spann3r_torch import pretraining as P
    from spann3r_torch.models import croco_pretrain as cp

    heads = 2 if pos == "cosine" else 1
    cfg, ratio = cp.parse_croco_model(
        f"CroCoNet(enc_embed_dim=64, enc_depth=3, enc_num_heads=1, "
        f"dec_embed_dim={32 * heads}, dec_depth=2, dec_num_heads={heads}, "
        f"img_size=48, pos_embed='{pos}')")
    model = cp.build_croco(cfg, "cpu", torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    img1, img2 = (torch.randn(2, 48, 48, 3, generator=g) for _ in range(2))
    mask = cp.random_mask(g, 2, 9, ratio)
    opt = P.make_pretrain_optimizer(0.05)
    step, _, _ = P.make_pretrain_step(ratio, C.FP32, opt)
    _, loss = step(model, opt.init(dict(model.named_parameters())), img1,
                   img2, mask, 1e-4)
    assert torch.isfinite(loss)
    want = chip_smoke.pretrain_launches(cfg)
    assert autograd_kernels.launch_counts() == want
    assert want["sdpa"] == want["sdpa_bwd"] == 2 * 3 + 2 * 2
    assert want["rope2d"] == (10 if pos == "RoPE100" else 0)


def test_pretrain_configurations_are_the_published_ones():
    """Phase 13's two configurations: CroCoNet()'s decoder has head dim 32,
    the v2 ViT-L / Base decoder is DUSt3R's backbone with RoPE100; the
    parity configuration runs K2 at both head dims and K3."""
    from spann3r_torch.models import croco_pretrain as cp

    a, ra = cp.parse_croco_model(chip_smoke.PRETRAIN_MODELS["CroCoNet()"])
    assert (a.enc.dim, a.enc.depth, a.enc.head_dim) == (768, 12, 64)
    assert (a.dec.dim, a.dec.depth, a.dec.head_dim) == (512, 8, 32)
    assert a.enc.rope_base == 0 and ra == 0.9 and a.img_size == (224, 224)
    b, _ = cp.parse_croco_model(chip_smoke.PRETRAIN_MODELS["v2 ViT-L/Base"])
    assert (b.enc.dim, b.enc.depth, b.enc.num_heads) == (1024, 24, 16)
    assert (b.dec.dim, b.dec.depth, b.dec.num_heads) == (768, 12, 12)
    assert b.enc.rope_base == 100.0
    c, _ = cp.parse_croco_model(chip_smoke.PRETRAIN_PARITY_MODEL)
    assert (c.enc.head_dim, c.dec.head_dim, c.enc.rope_base) == (64, 32, 100.0)


@pytest.mark.parametrize("name", ["CroCoNet()", "v2 ViT-L/Base"])
def test_phase3_holds_the_pretrain_attention_shapes(monkeypatch, name):
    """Phase 3's pretraining shapes (PRETRAIN_SHAPES and DH32_SHAPES'
    first) are the ones a pretrain step of each published configuration
    gives K2 and K3: heads, query and key tokens, head dim, self or cross
    attention, with or without RoPE, and the visible tokens' positions
    gathered, not the grid's first. Recorded on the CPU at the published
    widths with one block of each stack; the batch is phase 13's."""
    import dataclasses

    from spann3r_torch import config as C
    from spann3r_torch.models import croco_pretrain as cp
    from spann3r_torch.models import vit

    cfg, ratio = cp.parse_croco_model(chip_smoke.PRETRAIN_MODELS[name])
    cfg = dataclasses.replace(cfg, enc=dataclasses.replace(cfg.enc, depth=1),
                              dec=dataclasses.replace(cfg.dec, depth=1))
    model = cp.build_croco(cfg, "cpu", torch.Generator().manual_seed(0))
    layout, seen, rotated = [None], set(), set()

    def tagged(fn, tag):
        def run(*args, **kwargs):
            layout[0] = tag
            return fn(*args, **kwargs)
        return run

    def sdpa(q, k, v, scale):
        b, h, n, d = q.shape
        seen.add((h, n, k.shape[2], d, layout[0], cfg.enc.rope_base > 0))
        return attention.sdpa_plain(q, k, v, scale)

    def rope_2d_qk(q, k, qpos, kpos, base):
        grid = qpos[0].tolist() == [[i // 14, i % 14] for i in range(196)][
            :q.shape[2]]
        rotated.add((q.shape[1], q.shape[2], k.shape[2], q.shape[3],
                     layout[0], grid))
        return (rope.rope_2d_plain(q, qpos, base),
                rope.rope_2d_plain(k, kpos, base))

    monkeypatch.setattr(vit, "self_attention",
                        tagged(vit.self_attention, "self"))
    monkeypatch.setattr(vit, "cross_attention",
                        tagged(vit.cross_attention, "cross"))
    monkeypatch.setattr(attention, "sdpa", sdpa)
    monkeypatch.setattr(attention, "rope_2d_qk", rope_2d_qk)
    g = torch.Generator().manual_seed(1)
    img1, img2 = (torch.randn(2, 224, 224, 3, generator=g) for _ in range(2))
    mask = cp.random_mask(g, 2, 196, ratio)
    with torch.no_grad():
        cp.croco_forward(model, img1, img2, mask, ratio, C.FP32)

    shapes = chip_smoke.PRETRAIN_SHAPES + (
        (*chip_smoke.DH32_SHAPES[0], 32, "self", False),)
    ours = [s for s in shapes if s[0].startswith(name.split()[0])]
    assert {s[1] for s in ours} == {chip_smoke.PRETRAIN_B}
    assert seen == {(h, n, m, d, lay, r) for _, _, h, n, m, d, lay, r in ours}
    want_rope = {(h, n, m, d, lay, n == 196)
                 for _, _, h, n, m, d, lay, r in ours if r}
    assert rotated == want_rope


# ---------------------------------------------------------------------------
# phase 14 (align) and phase 3's allowance census (C2)
# ---------------------------------------------------------------------------

def test_align_scene_is_the_jax_tests_scene():
    """At the JAX test's 16x16 and 3 cameras, phase 14's scene is
    tests/test_global_align.py's, bit for bit."""
    import tests.test_global_align as JT

    out, world = chip_smoke.align_scene(JT.N, (JT.H, JT.W))
    want, want_world = JT._make_scene(None)
    np.testing.assert_array_equal(world, np.stack(want_world))
    for view, keys in (("view1", ("idx",)), ("view2", ("idx",)),
                       ("pred1", ("pts3d", "conf")),
                       ("pred2", ("pts3d_in_other_view", "conf"))):
        for k in keys:
            np.testing.assert_array_equal(np.asarray(out[view][k]),
                                          np.asarray(want[view][k]))


def test_align_check_catches_the_planted_fault():
    """Phase 14's check passes the aligned scene and rejects it with two
    edges' pred_j swapped (on the CPU at 64x48, 4 cameras)."""
    from spann3r_torch.models.global_align import global_aligner

    torch.set_num_threads(1)
    n, hw = chip_smoke.ALIGN_PARITY_N, chip_smoke.ALIGN_PARITY_HW
    out, world = chip_smoke.align_scene(n, hw)
    verdicts = []
    for o in (out, chip_smoke.swapped_edges(out)):
        al = global_aligner(o, device="cpu")
        loss = al.optimize(chip_smoke.ALIGN_NITER, chip_smoke.ALIGN_LR)
        corr, fit, _ = chip_smoke.align_errors(al, world)
        verdicts.append(chip_smoke.align_ok(loss, corr, fit))
    assert verdicts == [True, False]
    # the fault leaves the scene itself untouched
    assert not np.array_equal(chip_smoke.swapped_edges(out)["pred2"][
        "pts3d_in_other_view"], out["pred2"]["pts3d_in_other_view"])


@pytest.mark.parametrize("n,batch", [(4, 8), (3, 4)])
def test_pairwise_launch_counts(counting_kernels, n, batch):
    """Phase 14's expected launches (pairwise_launches) are what pairwise
    inference launches, stage by stage, on a tiny model whose decoders have
    their own head count, with a short last batch."""
    from spann3r_torch import config as C
    from spann3r_torch.models import inference, pairs
    from spann3r_torch.models import spann3r as S

    cfg = C.Spann3RConfig(
        dust3r=C.DUSt3RConfig(img_size=(32, 32), patch_size=16,
                              enc=C.ViTConfig(dim=64, depth=2, num_heads=4),
                              dec=C.ViTConfig(dim=48, depth=3, num_heads=2),
                              head_type="linear"),
        value_enc_depth=2, value_enc_dim=64, value_enc_heads=4,
        attn_head_in=64 + 48, attn_head_out=64)
    model = S.build_spann3r(cfg, "cpu", torch.Generator().manual_seed(0))
    views = [{"img": (_randn(1, 32, 32, 3, seed=30 + i) * 0.3).numpy(),
              "idx": i} for i in range(n)]
    prs = pairs.make_pairs(views, "complete", symmetrize=True)
    with chip_smoke.ShapeTally() as tally:
        out = inference.inference(prs, model.dust3r, cfg.dust3r, batch,
                                  C.FP32, verbose=False)
    assert out["pred1"]["pts3d"].shape == (len(prs), 32, 32, 3)
    want = chip_smoke.pairwise_launches(cfg, len(prs), batch)
    counts = counting_kernels.launch_counts()
    assert counts["memory_read"] == want["memory_read"] == 0
    for k in ("rope2d", "sdpa"):
        assert tally.by_stage(k, cfg, n) == want[k]
        assert counts[k] == sum(want[k].values())


def test_allowance_census_rejects_a_kernel_past_the_library():
    """C2: past_plain_bound counts the elements past the plain bound and
    those past the allowance too; the check passes a kernel that needs the
    allowance on no more elements than the library's lies past the plain
    bound (plus the margin), and rejects one that needs it on more."""
    plain = (_randn(2, 4, 64, 32, seed=40) * 0.1,)
    base = chip_smoke.TOL_BF16 * (plain[0].pow(2).mean(
        dim=(1, 2, 3), keepdim=True).sqrt() + plain[0].abs())
    allowance = (torch.full_like(plain[0], 1e-2),)
    library = (plain[0].to(torch.bfloat16),)       # one rounding: within
    kernel = plain[0].clone()
    flat = kernel.view(-1)
    k = chip_smoke.ALLOWANCE_MARGIN + 3
    flat[:k] += base.expand_as(kernel).reshape(-1)[:k] + 1e-3
    n, beyond, worst = chip_smoke.past_plain_bound((kernel,), plain, allowance)
    assert (n, beyond) == (k, 0) and 0.9e-3 < worst < 1.1e-3
    assert chip_smoke.past_plain_bound(library, plain, allowance)[0] == 0
    assert not chip_smoke.allowance_ok(n, 0)
    assert chip_smoke.allowance_ok(chip_smoke.ALLOWANCE_MARGIN, 0)
    assert chip_smoke.allowance_ok(n, n - chip_smoke.ALLOWANCE_MARGIN)
    # past the allowance too
    flat[0] += 1.0
    assert chip_smoke.past_plain_bound((kernel,), plain, allowance)[1] == 1


# ---------------------------------------------------------------------------
# phase 15 (stereo and flow finetuning) and its phase 3 shapes
# ---------------------------------------------------------------------------

def _narrow_stereoflow_cfg(hw):
    from spann3r_torch.models.croco_downstream import croco_kwargs_from_cfg
    from spann3r_torch.models.croco_pretrain import parse_croco_model
    from spann3r_torch.stereoflow import engine as sfe

    cfg, _ = parse_croco_model(
        "CroCoNet(enc_embed_dim=64, enc_depth=3, enc_num_heads=1, "
        "dec_embed_dim=64, dec_depth=2, dec_num_heads=1, "
        "pos_embed='RoPE100')")
    return sfe.cfg_from_croco_args(croco_kwargs_from_cfg(cfg), hw)


@pytest.mark.parametrize("task", ["stereo", "flow"])
def test_stereoflow_launch_counts(autograd_kernels, task):
    """chip_smoke's stereoflow_launches is what one stereo or flow train
    step launches: K2 both ways in each encoder block (once, over both
    images) and in each decoder block's self and cross attention, K3 both
    ways with RoPE100, no K1."""
    from spann3r_torch import config as C
    from spann3r_torch.stereoflow import criterion as sfc
    from spann3r_torch.stereoflow import engine as sfe

    torch.set_num_threads(1)
    cfg = _narrow_stereoflow_cfg((32, 48))
    crit = sfc.build_criterion(chip_smoke.STEREOFLOW_CELLS[task][4])
    nc = (1 if task == "stereo" else 2) + 1
    model, _ = sfe.init_stereoflow(torch.Generator().manual_seed(0), cfg, nc,
                                   "cpu")
    g = torch.Generator().manual_seed(1)
    img1, img2 = (torch.randn(2, 32, 48, 3, generator=g) for _ in range(2))
    gt = torch.rand(2, 32, 48, nc - 1, generator=g) * 4
    opt = sfe.make_optimizer(0.05)
    step = sfe.make_train_step(cfg, crit, task, opt, C.FP32)
    _, loss, _ = step(model, opt.init(dict(model.named_parameters())), img1,
                      img2, gt, 1e-4)
    assert torch.isfinite(loss)
    want = chip_smoke.stereoflow_launches(cfg, task)
    assert autograd_kernels.launch_counts() == want
    assert want["sdpa"] == want["sdpa_bwd"] == want["rope2d"] == 3 + 2 * 2


def test_stereoflow_tiled_launch_counts(autograd_kernels):
    """A tiled prediction launches the forward's K2 and K3 once a chunk of
    tiles (the tail chunk padded), nothing backward."""
    from spann3r_torch import config as C
    from spann3r_torch.stereoflow import engine as sfe
    from spann3r_torch.stereoflow.tiling import tile_slices, tiled_pred

    torch.set_num_threads(1)
    cfg = _narrow_stereoflow_cfg((32, 48))
    model, _ = sfe.init_stereoflow(torch.Generator().manual_seed(0), cfg, 2,
                                   "cpu")
    rng = np.random.default_rng(2)
    img1, img2 = (rng.standard_normal((1, 48, 72, 3)).astype(np.float32)
                  for _ in range(2))
    n_tiles = len(tile_slices(48, 32, 0.7)) * len(tile_slices(72, 48, 0.7))
    pred, _, _ = tiled_pred(sfe.make_tile_fn(model, cfg, C.FP32), None, img1,
                            img2, None, crop=(32, 48), overlap=0.7,
                            with_conf=True, num_channels=1, tile_batch=4)
    assert pred.shape == (1, 48, 72, 1) and n_tiles == 9
    assert autograd_kernels.launch_counts() == chip_smoke.stereoflow_launches(
        cfg, "tiled", chunks=3)


def test_stereoflow_cells_are_the_published_recipes():
    """Phase 15's cells: CroCo-Stereo's and CroCo-Flow's crops, batches,
    criteria and LRs (croco/stereoflow/train.py's defaults, which the
    parser in stereoflow/driver.py keeps) on the v2 ViT-L / Base decoder with
    RoPE100."""
    from spann3r_torch.models.croco_pretrain import parse_croco_model
    from spann3r_torch.stereoflow.driver import get_args_parser

    cfg, _ = parse_croco_model(chip_smoke.STEREOFLOW_MODEL)
    assert (cfg.enc.dim, cfg.enc.depth, cfg.dec.dim, cfg.dec.depth,
            cfg.enc.rope_base) == (1024, 24, 768, 12, 100.0)
    for task, (_, _, crop, b, spec, lr, _) in \
            chip_smoke.STEREOFLOW_CELLS.items():
        a = get_args_parser().parse_args([task, "--output_dir", "x",
                                          "--dataset", "y"])
        assert (tuple(a.crop), a.batch_size, a.criterion, a.lr) == \
            (crop, b, spec, lr)
    assert chip_smoke.STEREOFLOW_TILE_BATCH == a.tile_batch
    assert chip_smoke.STEREOFLOW_OVERLAP == a.val_overlap


@pytest.mark.parametrize("task", ["stereo", "flow", "tiled"])
def test_phase3_holds_the_stereoflow_attention_shapes(monkeypatch, task):
    """Phase 3's stereoflow shapes (STEREOFLOW_SHAPES) are the ones the
    binocular forward of the published configuration gives K2 and K3 at
    each cell's crop: heads, query and key tokens, head dim, self or
    cross, RoPE, and the batch (the encoder over both images of B pairs,
    the decoder over image 1's; the tiled test's B is tile_batch).
    Recorded on the CPU at the published widths with one block of each
    stack and one pair, the batch scaled; positions the patch grid's."""
    import dataclasses

    from spann3r_torch import config as C
    from spann3r_torch.models import croco_downstream as cd
    from spann3r_torch.models import vit
    from spann3r_torch.models.croco_downstream import croco_kwargs_from_cfg
    from spann3r_torch.models.croco_pretrain import parse_croco_model
    from spann3r_torch.stereoflow import engine as sfe

    torch.set_num_threads(1)
    cell = chip_smoke.STEREOFLOW_CELLS["stereo" if task == "tiled" else task]
    crop, b = cell[2], (chip_smoke.STEREOFLOW_TILE_BATCH if task == "tiled"
                        else cell[3])
    cfg = sfe.cfg_from_croco_args(croco_kwargs_from_cfg(parse_croco_model(
        chip_smoke.STEREOFLOW_MODEL)[0]), crop)
    cfg = dataclasses.replace(cfg, enc=dataclasses.replace(cfg.enc, depth=1),
                              dec=dataclasses.replace(cfg.dec, depth=1))
    model = cd.croco_backbone(cfg, "cpu", torch.Generator().manual_seed(0))
    layout, seen, rotated = [None], set(), set()
    grid = chip_smoke.STEREOFLOW_GRID[(crop[0] // 16) * (crop[1] // 16)]
    want_pos = vit.patch_positions(*grid)

    def tagged(fn, tag):
        def run(*args, **kwargs):
            layout[0] = tag
            return fn(*args, **kwargs)
        return run

    def sdpa(q, k, v, scale):
        bq, h, n, d = q.shape
        seen.add((bq, h, n, k.shape[2], d, layout[0]))
        return torch.zeros_like(q)

    def rope_2d_qk(q, k, qpos, kpos, base):
        assert base == 100.0
        assert torch.equal(qpos[0], want_pos) and torch.equal(kpos[0],
                                                              want_pos)
        rotated.add((q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                     q.shape[3], layout[0]))
        return q, k

    monkeypatch.setattr(vit, "self_attention",
                        tagged(vit.self_attention, "self"))
    monkeypatch.setattr(vit, "cross_attention",
                        tagged(vit.cross_attention, "cross"))
    monkeypatch.setattr(attention, "sdpa", sdpa)
    monkeypatch.setattr(attention, "rope_2d_qk", rope_2d_qk)
    img = torch.zeros(1, *crop, 3)
    with torch.no_grad():
        cd.downstream_binocular(model, img, img, cfg, lambda s, hw: None,
                                C.FP32)

    def scaled(bq, *rest):
        # one pair here: the encoder's batch 2, the decoder's 1
        return (bq * b, *rest)

    ours = [s for s in chip_smoke.STEREOFLOW_SHAPES
            if s[0].startswith(task)]
    want = {(bb, h, n, m, d, lay) for _, bb, h, n, m, d, lay, _ in ours}
    assert {scaled(*s) for s in seen} == want
    assert {scaled(*s) for s in rotated} == want
    assert all(r for *_, r in ours)
