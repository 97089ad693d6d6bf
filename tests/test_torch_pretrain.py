"""CroCo pretraining in the port against the JAX package, on the CPU: the
CroCoNet forward (cosine and RoPE100 positions, a head-dim-32 decoder),
MaskedMSE, the exact-count masks, the model-string parser, the layer-decay
LR scales, one pretrain step and one accumulated step, the non-finite gate,
data parallel over two gloo processes against one process on the global
batch, the CLI (train, checkpoint, resume) and the demo on its checkpoint.

Tolerances (FP32): the forward's predictions within 1e-5 of max |pred| and
the loss within 1e-5 relative (sums in another order); the gradients within
1e-4 of the largest |grad|; the updated weights by `_check_updates`' rule
(the first Adam step turns any gradient into about lr * sign(grad)); the
two-rank step within 1e-6 of the one-process step (the same arithmetic on
two halves, summed).

Run alone, the file's data-parallel workers run as
`python -m tests.test_torch_pretrain worker <dir>`.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from spann3r_tpu import config as JCFG
from spann3r_tpu import pretraining as JP
from spann3r_tpu import training as JT
from spann3r_tpu.models import croco_downstream as JD
from spann3r_tpu.models import croco_pretrain as JC
from spann3r_torch import config as TCFG
from spann3r_torch import pretrain as TCLI
from spann3r_torch import pretraining as TP
from spann3r_torch import training as TT
from spann3r_torch.models import croco_pretrain as TC
from spann3r_torch.tools import croco_demo
from spann3r_torch.utils.convert import state_dict_from_croco_params
from tests.test_torch_training import WD, _check_updates

REPO = Path(__file__).resolve().parent.parent
LR = 1e-4
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
DP_TOL = 1e-6
WORKER_TIMEOUT = 300
# encoder head dim 64, decoder head dim 32 (the CroCoNet() decoder's), 16
# patches: 14 masked, 2 visible
NARROW = ("CroCoNet(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, "
          "dec_embed_dim=64, dec_depth=2, dec_num_heads=2, img_size=64, "
          "pos_embed='{}')")
MODES = ("cosine", "RoPE100")
J_FP32 = JCFG.Precision(compute_dtype=jnp.float32)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: at these shapes more threads only contend with
    the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(mode="cosine", seed=0):
    """The JAX params and the port's CroCoNet with the same weights."""
    jcfg, ratio = JP.parse_croco_model(NARROW.format(mode))
    tcfg, _ = TC.parse_croco_model(NARROW.format(mode))
    params = JC.init_croco(jax.random.PRNGKey(seed), jcfg)
    model = TC.CroCoNet(tcfg)
    model.load_state_dict(state_dict_from_croco_params(
        jax.tree.map(np.asarray, params)), strict=True)
    return jcfg, ratio, params, model


def _images(seed, b=2, hw=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
                 for _ in range(2))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _as_port(tree):
    """A JAX params-shaped pytree as the port's {name: tensor}."""
    return state_dict_from_croco_params(jax.tree.map(np.asarray, tree))


def _jax_mask(key, b, ratio, n=16):
    return np.asarray(JC.random_mask(key, b, n, ratio))


# ---------------------------------------------------------------------------
# model, masks, loss, parser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_croco_forward_matches_jax(mode):
    jcfg, ratio, params, model = _models(mode)
    assert model.cfg.dec.head_dim == 32 and model.cfg.enc.head_dim == 64
    i1, i2 = _images(1)
    mask = _jax_mask(jax.random.PRNGKey(2), 2, ratio)
    fwd = jax.jit(lambda p, a, b, m: JC.croco_forward(p, a, b, m, jcfg, ratio,
                                                      J_FP32))
    jp, _, jt = fwd(params, jnp.asarray(i1), jnp.asarray(i2),
                    jnp.asarray(mask))
    tp, tm, tt = TC.croco_forward(model, _t(i1), _t(i2), _t(mask), ratio,
                                  TCFG.FP32)
    jp = np.asarray(jp)
    assert tp.dtype == torch.float32 and tp.shape == jp.shape == (2, 16, 768)
    np.testing.assert_allclose(tp.detach().numpy(), jp, rtol=0,
                               atol=FWD_TOL * np.abs(jp).max())
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert torch.equal(tm, _t(mask))


@pytest.mark.parametrize("norm_pix", [False, True])
@pytest.mark.parametrize("masked", [True, False])
def test_masked_mse_matches_jax(norm_pix, masked):
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((2, 16, 48)).astype(np.float32)
    target = rng.standard_normal((2, 16, 48)).astype(np.float32) * 2 + 1
    mask = rng.random((2, 16)) > 0.3
    want = float(JC.masked_mse(jnp.asarray(pred), jnp.asarray(mask),
                               jnp.asarray(target), norm_pix, masked))
    got = float(TC.masked_mse(_t(pred), _t(mask), _t(target), norm_pix,
                              masked))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("ratio,n", [(0.9, 196), (0.75, 16), (0.5, 7)])
def test_random_mask_has_the_exact_count(ratio, n):
    g = torch.Generator().manual_seed(4)
    mask = TC.random_mask(g, 5, n, ratio)
    assert mask.dtype == torch.bool and mask.shape == (5, n)
    assert (mask.sum(1) == int(ratio * n)).all()
    assert not torch.equal(mask[0], mask[1])


def test_mask_of_another_ratio_is_refused():
    jcfg, ratio, _, model = _models()
    i1, i2 = _images(5)
    mask = TC.random_mask(torch.Generator().manual_seed(0), 2, 16, 0.5)
    with pytest.raises(ValueError, match="masked tokens"):
        TC.croco_forward(model, _t(i1), _t(i2), mask, ratio, TCFG.FP32)


def test_patchify_roundtrip_matches_jax():
    img = np.random.default_rng(6).standard_normal((2, 32, 48, 3)).astype(
        np.float32)
    p = TC.patchify(_t(img), 16)
    np.testing.assert_array_equal(p.numpy(),
                                  np.asarray(JC.patchify(jnp.asarray(img), 16)))
    assert torch.equal(TC.unpatchify(p, 16, 32, 48), _t(img))


# the model strings of tests/test_pretrain_driver.py's parser test
MODEL_STRINGS = (
    "CroCoNet()",
    "CroCoNet(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, "
    "dec_embed_dim=48, dec_depth=2, dec_num_heads=4, img_size=32, "
    "mask_ratio=0.75, pos_embed='RoPE100')",
    "CroCoNet(enc_embed_dim=1024, enc_depth=24, enc_num_heads=16, "
    "dec_embed_dim=768, dec_depth=12, dec_num_heads=12, pos_embed='RoPE100')",
)


@pytest.mark.parametrize("s", MODEL_STRINGS)
def test_parse_croco_model_matches_jax(s):
    (tcfg, tr), (jcfg, jr) = TC.parse_croco_model(s), JP.parse_croco_model(s)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg) and tr == jr
    assert TC.croco_kwargs_from_cfg(tcfg) == JD.croco_kwargs_from_cfg(jcfg)


@pytest.mark.parametrize("s", ["__import__('os').system('true')",
                               "CroCoNet(bogus_kwarg=1)", "CroCoNet(1)"])
def test_parse_croco_model_refuses(s):
    with pytest.raises(ValueError):
        TC.parse_croco_model(s)
    with pytest.raises(ValueError):
        JP.parse_croco_model(s)


@pytest.mark.parametrize("decay", [0.75, 1.0])
def test_layer_lr_scales_match_jax(decay):
    jcfg, _, params, model = _models()
    want = JT.layer_lr_scales(params, 2, 2, decay)
    names = [n for n, _ in model.named_parameters()]
    got = TT.layer_lr_scales(names, 2, 2, decay)
    assert set(got) == set(names)
    stacks = {"enc_blocks": want["enc_blocks"], "dec_blocks": want["dec_blocks"]}
    for n in names:
        top = n.split(".")[0]
        if top in stacks:
            w = float(np.asarray(jax.tree.leaves(stacks[top])[0])
                      .reshape(-1)[int(n.split(".")[1])])
        else:
            w = float(np.asarray(jax.tree.leaves(want[top])[0]))
        assert got[n] == pytest.approx(w, rel=1e-6), n
    with pytest.raises(NotImplementedError):
        TT.layer_lr_scales(["bogus.weight"], 2, 2, decay)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _jax_grads(params, jcfg, ratio, i1, i2, mask):
    def loss_fn(p, a, b, m):
        pred, m, target = JC.croco_forward(p, a, b, m, jcfg, ratio, J_FP32)
        return JC.masked_mse(pred, m, target, norm_pix_loss=True)
    return jax.jit(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(mask))


@pytest.mark.parametrize("mode", MODES)
def test_pretrain_step_matches_jax(mode):
    """The loss and gradients of one batch, then one optimizer step,
    against make_pretrain_step on the same weights, images and mask (the
    JAX step draws its mask from the key it is given)."""
    jcfg, ratio, params, model = _models(mode)
    old = {k: v.detach().clone() for k, v in model.named_parameters()}
    i1, i2 = _images(7)
    key = jax.random.PRNGKey(8)
    mask = _jax_mask(key, 2, ratio)
    jloss, jgrads = _jax_grads(params, jcfg, ratio, i1, i2, mask)
    tloss, tgrads = TP.pretrain_loss_and_grads(model, _t(i1), _t(i2),
                                               _t(mask), ratio, TCFG.FP32)
    assert abs(float(tloss) - float(jloss)) <= FWD_TOL * abs(float(jloss))
    want = _as_port(jgrads)
    gmax = max(float(v.abs().max()) for v in want.values())
    for k, g in tgrads.items():
        assert float((g - want[k]).abs().max()) <= GRAD_TOL * gmax, k

    jopt = JP.make_pretrain_optimizer(WD)
    jstep, _, _ = JP.make_pretrain_step(jcfg, ratio, J_FP32, jopt)
    jparams, jstate, jl = jstep(params, jopt.init(params), jnp.asarray(i1),
                                jnp.asarray(i2), key, jnp.float32(LR))
    topt = TP.make_pretrain_optimizer(WD)
    tstep, _, _ = TP.make_pretrain_step(ratio, TCFG.FP32, topt)
    tstate, tl = tstep(model, topt.init(dict(model.named_parameters())),
                       _t(i1), _t(i2), _t(mask), LR)
    assert abs(float(tl) - float(jl)) <= FWD_TOL * abs(float(jl))
    assert int(tstate.count) == 1
    _check_updates({k: v.detach() for k, v in model.named_parameters()}, old,
                   _as_port(jparams), _as_port(jstate[0].mu), lr=LR)


def test_accumulated_step_matches_jax():
    jcfg, ratio, params, model = _models("RoPE100")
    old = {k: v.detach().clone() for k, v in model.named_parameters()}
    jopt, topt = JP.make_pretrain_optimizer(WD), TP.make_pretrain_optimizer(WD)
    _, jgrad, japply = JP.make_pretrain_step(jcfg, ratio, J_FP32, jopt)
    _, tgrad, tapply = TP.make_pretrain_step(ratio, TCFG.FP32, topt)
    jacc = jax.tree.map(jnp.zeros_like, params)
    tacc = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    for i in range(2):
        i1, i2 = _images(10 + i)
        key = jax.random.PRNGKey(20 + i)
        jacc, _ = jgrad(params, jacc, jnp.asarray(i1), jnp.asarray(i2), key,
                        jnp.float32(0.5))
        tacc, _ = tgrad(model, tacc, _t(i1), _t(i2),
                        _t(_jax_mask(key, 2, ratio)), 0.5)
    want = _as_port(jacc)
    gmax = max(float(v.abs().max()) for v in want.values())
    for k, a in tacc.items():
        assert float((a - want[k]).abs().max()) <= GRAD_TOL * gmax, k
    jparams, jstate, _ = japply(params, jopt.init(params), jacc,
                                jnp.float32(LR))
    tstate, tacc = tapply(model, topt.init(dict(model.named_parameters())),
                          tacc, LR)
    assert all(float(a.abs().max()) == 0 for a in tacc.values())
    _check_updates({k: v.detach() for k, v in model.named_parameters()}, old,
                   _as_port(jparams), _as_port(jstate[0].mu), lr=LR)


def test_nonfinite_step_leaves_the_state():
    """An image with a NaN gives a non-finite gradient: the step leaves the
    weights, the moments and the count as they were (decided on the
    device), and so does a micro-batch of an accumulated step."""
    _, ratio, _, model = _models()
    i1, i2 = _images(12)
    i1[0, 3, 3, 0] = np.nan
    mask = TC.random_mask(torch.Generator().manual_seed(1), 2, 16, ratio)
    old = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = TP.make_pretrain_optimizer(WD)
    state0 = opt.init(dict(model.named_parameters()))
    step, grad_step, _ = TP.make_pretrain_step(ratio, TCFG.FP32, opt)
    state, loss = step(model, state0, _t(i1), _t(i2), mask, LR)
    assert not torch.isfinite(loss)
    assert int(state.count) == 0
    for k, v in model.named_parameters():
        assert torch.equal(v.detach(), old[k])
        assert float(state.mu[k].abs().max()) == 0
    acc = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    acc, _ = grad_step(model, acc, _t(i1), _t(i2), mask, 0.5)
    assert all(float(a.abs().max()) == 0 for a in acc.values())


def test_decay_rule_matches_jax():
    """The pretrain optimizer decays what optax's mask does on CroCo's
    stacked params: leaves of two or more dimensions, so every parameter
    of the block stacks, the mask token and the weights; not the norms'
    and the loose biases."""
    _, _, params, model = _models()
    decays = JT.decay_mask(params)
    jmask = _as_port(jax.tree.map(lambda x, d: np.full(x.shape, float(d),
                                                       np.float32),
                                  params, decays))
    for n, p in model.named_parameters():
        assert TP.decay_mask(n, p.shape) == bool(jmask[n].reshape(-1)[0]), n


# ---------------------------------------------------------------------------
# data parallel: two gloo processes
# ---------------------------------------------------------------------------

class Items:
    """n pairs of 2x2 images holding their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        a = np.full((2, 2, 3), i, np.float32)
        return a, a + 100


def _global_batch():
    i1, i2 = _images(30, b=4)
    mask = TC.random_mask(torch.Generator().manual_seed(31), 4, 16, 0.9)
    return _t(i1), _t(i2), mask


def worker(out):
    """One rank: its half of the global batch, one step."""
    import torch.distributed as dist

    from spann3r_torch.parallel import mesh as pmesh
    torch.set_num_threads(1)
    pmesh.init_distributed("cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    _, ratio, _, model = _models("RoPE100")
    i1, i2, mask = _global_batch()
    part = slice(2 * rank, 2 * rank + 2)
    loss, grads = TP.pretrain_loss_and_grads(
        model, i1[part], i2[part], mask[part], ratio, TCFG.FP32,
        group=dist.group.WORLD, world=world)
    opt = TP.make_pretrain_optimizer(WD)
    step, _, _ = TP.make_pretrain_step(ratio, TCFG.FP32, opt,
                                       group=dist.group.WORLD, world=world)
    _, sloss = step(model, opt.init(dict(model.named_parameters())),
                    i1[part], i2[part], mask[part], LR)
    loader = TP.PairLoader(Items(11), 2, seed=3, world=world, rank=rank)
    torch.save({"loss": float(loss), "step_loss": float(sloss),
                "grads": grads, "batches": len(list(iter(loader))),
                "params": {k: v.detach() for k, v in
                           model.named_parameters()}},
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
    print("WORKER_OK", rank, flush=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_data_parallel_matches_one_process(tmp_path):
    """Two gloo ranks, each on half of the global batch: the loss, the
    gradients and the step equal the one-process step on the whole batch;
    both ranks end with the same weights."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        log = open(tmp_path / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_pretrain", "worker",
             str(tmp_path)], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    _, ratio, _, model = _models("RoPE100")
    old = {k: v.detach().clone() for k, v in model.named_parameters()}
    i1, i2, mask = _global_batch()
    loss, grads = TP.pretrain_loss_and_grads(model, i1, i2, mask, ratio,
                                             TCFG.FP32)
    opt = TP.make_pretrain_optimizer(WD)
    step, _, _ = TP.make_pretrain_step(ratio, TCFG.FP32, opt)
    step(model, opt.init(dict(model.named_parameters())), i1, i2, mask, LR)
    deadline = time.time() + WORKER_TIMEOUT
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    res = []
    for rank, (p, _) in enumerate(procs):
        text = (tmp_path / f"rank{rank}.log").read_text()
        assert p.returncode == 0 and f"WORKER_OK {rank}" in text, text[-3000:]
        res.append(torch.load(tmp_path / f"rank{rank}.pt"))
    gmax = max(float(g.abs().max()) for g in grads.values())
    for r in res:
        assert abs(r["loss"] - float(loss)) <= DP_TOL * abs(float(loss))
        assert r["step_loss"] == r["loss"]
        for k, g in r["grads"].items():
            assert float((g - grads[k]).abs().max()) <= DP_TOL * gmax, k
        # each rank reads 11 // (2 * 2) batches, the same count
        assert r["batches"] == 2
    new = {k: v.detach() for k, v in model.named_parameters()}
    for k in new:
        assert torch.equal(res[0]["params"][k], res[1]["params"][k])
        sure = grads[k].abs() > 1e-3 * gmax
        err = (res[0]["params"][k] - new[k]).abs()
        assert float(torch.cat([err[sure], err.new_zeros(1)]).max()) \
            <= DP_TOL * LR + 1e-7, k
        assert float(err.max()) <= 2 * LR * (1 + WD * float(
            old[k].abs().max())) + 1e-7, k


def test_pair_loader_matches_jax_and_gives_equal_batches():
    """The port's PairLoader yields the JAX one's batches, and every rank
    the same count whatever the world, with no item twice."""
    for n, bs, world in ((11, 2, 2), (5, 2, 8), (16, 3, 4)):
        seen = []
        for r in range(world):
            t = TP.PairLoader(Items(n), bs, seed=1, world=world, rank=r)
            j = JP.PairLoader(Items(n), bs, seed=1, world=world, rank=r)
            t.set_epoch(2)
            j.set_epoch(2)
            tb, jb = list(t), list(j)
            assert len(tb) == len(t) == n // (bs * world) == len(jb)
            for (a, b), (c, d) in zip(tb, jb):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, d)
                seen.extend(int(v) for v in a[:, 0, 0, 0])
        assert len(seen) == len(set(seen))


# ---------------------------------------------------------------------------
# the CLI and the demo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pretrain_run(tmp_path_factory):
    """`python -m spann3r_torch.pretrain` (its main) on the CPU on a
    habitat_release of box-room pairs from the port's generator: one epoch,
    then a second call that resumes it for a second epoch."""
    from spann3r_torch.datasets.pairs import parse_and_cache_all_pairs
    from spann3r_torch.habitat_gen.scripts import \
        generate_multiview_images_for_scene

    data = tmp_path_factory.mktemp("pretrain_data")
    generate_multiview_images_for_scene(
        scene_dataset_config_file="", scene="__boxroom__", navmesh="",
        output_dir=str(data / "habitat_release" / "scene0"), views_count=2,
        size=4, generate_depth=False, resolution=(80, 80), hfov=60,
        minimum_covisibility=0.2)
    parse_and_cache_all_pairs("habitat_release", str(data))
    out = tmp_path_factory.mktemp("pretrain_out")
    argv = ["--device", "cpu", "--data_dir", str(data), "--output_dir",
            str(out), "--model", NARROW.format("RoPE100"), "--transforms",
            "crop64+acolor", "--batch_size", "2", "--warmup_epochs", "1",
            "--epochs", "4", "--print_freq", "1", "--keep_freq", "1",
            "--lr", "1e-4"]
    first = TCLI.main(argv + ["--max_epoch", "1"])
    second = TCLI.main(argv + ["--max_epoch", "2"])
    return out, first, second, str(data)


def test_cli_trains_checkpoints_and_resumes(pretrain_run):
    from spann3r_torch.utils.convert import read_checkpoint

    out, first, second, _ = pretrain_run
    assert first["epoch"] == 0 and second["epoch"] == 1
    assert np.isfinite(first["train_loss"]) and np.isfinite(
        second["train_loss"])
    # 4 pairs at batch 2: two steps an epoch
    assert int(first["opt_state"].count) == 2
    assert int(second["opt_state"].count) == 4
    ck = read_checkpoint(str(out / "checkpoint-last.pth"))
    assert set(ck) >= {"model", "optimizer", "epoch", "args"}
    assert ck["epoch"] == 1 and int(ck["optimizer"]["count"]) == 4
    assert (out / "checkpoint-0.pth").exists()
    for k, v in second["model"].state_dict().items():
        assert torch.equal(ck["model"][k], v)
    lines = (out / "log.txt").read_text().splitlines()
    assert len(lines) == 2


def test_croco_demo_restores_the_checkpoint(pretrain_run, tmp_path):
    """The demo restores checkpoint-last.pth and writes the 4-panel image;
    the reconstruction panel differs from the random-weight one."""
    out, _, second, data = pretrain_run
    img = str(next(Path(data, "habitat_release", "scene0").glob("*_1.jpeg")))
    img2 = img.replace("_1.jpeg", "_2.jpeg")
    png = tmp_path / "demo.png"
    croco_demo.main(["--img1", img, "--img2", img2, "--model",
                     NARROW.format("RoPE100"), "--ckpt", str(out),
                     "--output", str(png), "--device", "cpu"])
    vis = np.asarray(PIL.Image.open(png))
    assert vis.shape == (64, 4 * 64, 3) and vis.dtype == np.uint8
    cfg, _ = TC.parse_croco_model(NARROW.format("RoPE100"))
    a = croco_demo._load_image(img, cfg.img_size)
    b = croco_demo._load_image(img2, cfg.img_size)
    noise = croco_demo.run_demo(a, b, NARROW.format("RoPE100"), None, 0, "cpu")
    np.testing.assert_array_equal(vis[:, :64], noise[:, :64])
    assert not np.array_equal(vis[:, 128:192], noise[:, 128:192])
    with pytest.raises(FileNotFoundError):
        croco_demo.run_demo(a, b, NARROW.format("RoPE100"), str(tmp_path), 0,
                            "cpu")


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
