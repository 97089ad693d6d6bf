"""The checks of chip_smoke.py, on the CPU at small shapes: the bound that
holds each kernel against its plain version passes a result that differs
by one bf16 rounding and rejects the planted faults the script runs on the
card; the script refuses to run without a card."""
import subprocess
import sys
from pathlib import Path

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
