"""Multi-process training of the port over gloo on the CPU: real worker
processes (this file run as `python -m tests.test_torch_distributed
worker ...`, one thread each, each run under a timeout) against the JAX
package's one-process step on the global batch, as
tests/test_multiprocess.py runs the JAX trainer over two processes.

The configuration is tests/mp_worker.py's tiny one (32x32, encoder 2 x 64,
decoders 2 x 48, linear head, value encoder 2 x 64) with memory dropout
off for the JAX comparisons, on a global batch of 4 SynthRoom clips of 3
frames with uneven random valid masks (each clip keeps another share of
its pixels, so the ranks hold different valid counts). The layouts:
data 2 (B = 2 each) with --fsdp 0 and 1, model 2, and data 2 x model 2
with --fsdp 1; `tp_min_dim` 32 splits and slices every block.

Tolerances: the train-step bounds of tests/test_torch_training.py (loss
and grad norm 1e-4 relative, moments 1e-4 of their largest, the updates
`_check_updates`); the replicated tensors' gradients equal across the
model ranks (the ranks sum the same values in the same order); the port
at data 2 against the port in one process on the concatenated batch with
dropout on, loss 1e-6 relative and parameters 1e-6 of the largest update
(the same operations; only the sums over the ranks add in another
order); the merged eval against one process's, 1e-5 relative.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from spann3r_torch import config as TC
from spann3r_torch import training as TT
from spann3r_torch.datasets import build_dataset
from spann3r_torch.datasets.loader import collate_views
from spann3r_torch.models import spann3r as TS
from spann3r_torch.parallel import mesh as pmesh
from spann3r_torch.parallel import sharding

REPO = Path(__file__).resolve().parent.parent
LR, WD, ALPHA = 1e-4, 0.05, 0.4
B_GLOBAL, T = 4, 3
# the share of each clip's pixels that is valid
KEEP = (0.9, 0.3, 0.6, 0.15)
TRAIN_SET = ("SynthRoom(num_seq=8, num_frames=3, resolution=32, seq_len=8, "
             "seed=11)")
EVAL_SET = ("SynthRoom(num_seq={n}, num_frames=3, resolution=32, seq_len=8, "
            "scene_seed=3, seed=777)")
WORKER_TIMEOUT = 300
SAME_TOL = 1e-6


def tiny_cfg(mod, dropout=0.0):
    """tests/mp_worker.py's configuration (`mod`: either package's config),
    memory dropout at `dropout`."""
    return mod.Spann3RConfig(
        dust3r=mod.DUSt3RConfig(img_size=(32, 32), patch_size=16,
                                enc=mod.ViTConfig(dim=64, depth=2, num_heads=4),
                                dec=mod.ViTConfig(dim=48, depth=2, num_heads=4),
                                head_type="linear"),
        memory=mod.MemoryConfig(mem_dropout=dropout),
        value_enc_depth=2, value_enc_dim=64, value_enc_heads=4,
        attn_head_in=64 + 48, attn_head_out=64)


def global_batch(seed):
    """B_GLOBAL SynthRoom clips, (T, B, ...), each clip with its share of
    valid pixels."""
    ds = build_dataset(TRAIN_SET)
    ds.set_epoch(0)
    ds.set_ratio(1.0)
    batch = collate_views([ds[(seed * B_GLOBAL + i) % len(ds)]
                           for i in range(B_GLOBAL)])
    rng = np.random.default_rng(seed)
    u = rng.random(batch["valid_mask"].shape)
    batch["valid_mask"] = u < np.asarray(KEEP)[None, :, None, None]
    return batch


def rows(batch, rank, n):
    """A data rank's part of a (T, B, ...) batch."""
    b = B_GLOBAL // n
    return {k: v[:, rank * b:(rank + 1) * b] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the worker (one rank)
# ---------------------------------------------------------------------------

def _fresh(cfg, init, mesh, fsdp):
    """The model on `init`'s weights, cut to this rank's layout."""
    model = TS.build_spann3r(cfg, "cpu", torch.Generator().manual_seed(0))
    model.load_state_dict(init)
    layout = sharding.Layout(model, cfg, mesh, fsdp, min_dim=32)
    layout.shard_model_(model)
    return model, layout


def _step(cfg, init, mesh, batch, fsdp, gen_seed=None, remat=False,
          remat_scan=False):
    """One FP32 train step on this rank's part of `batch`: the loss, the
    grad norm, the full gradients, the full weights and moments after the
    step, and the replicated tensors' own (data-summed) gradients."""
    model, layout = _fresh(cfg, init, mesh, fsdp)
    qkv = dict(model.named_parameters())[
        "dust3r.enc_blocks.0.attn.qkv.weight"].detach().clone()
    local = TT.batch_to_device(rows(batch, mesh.data_rank, mesh.data), "cpu")
    gen = (None if gen_seed is None
           else torch.Generator().manual_seed(gen_seed))
    _, _, g = TT.value_and_grad(model, cfg, TC.FP32, local, gen, ALPHA,
                                layout=layout, remat=remat,
                                remat_scan=remat_scan)
    g = layout.reduce_grads(g)
    replicated = {n: t.clone() for n, t in g.items()
                  if n not in layout.tp and n not in layout.fsdp}
    grads = layout.full_tensors(g)
    opt = TT.make_optimizer(WD)
    st = opt.init(dict(model.named_parameters()))
    gen = (None if gen_seed is None
           else torch.Generator().manual_seed(gen_seed))
    step = TT.make_train_step(cfg, TC.FP32, opt, grads_bf16=False,
                              layout=layout, remat=remat,
                              remat_scan=remat_scan)
    st, m = step(model, st, rows(batch, mesh.data_rank, mesh.data), gen, LR,
                 ALPHA)
    return {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
            "grads": grads, "replicated": replicated,
            "params": _full_weights(model, layout),
            "mu": layout.full_tensors(st.mu), "qkv": qkv,
            "model": model, "layout": layout, "state": st}


def _full_weights(model, layout):
    return {k: v.detach() for k, v in layout.full_tensors(
        dict(model.named_parameters())).items()}


def _public(r):
    return {k: v for k, v in r.items() if k not in ("model", "layout",
                                                    "state")}


def _data2(mesh, out, init):
    cfg, cfg_drop = tiny_cfg(TC), tiny_cfg(TC, dropout=0.15)
    batch = global_batch(0)
    res = {"fsdp0": _public(_step(cfg, init, mesh, batch, False))}
    sliced = _step(cfg, init, mesh, batch, True)
    res["fsdp1"] = _public(sliced)
    res["slice_numel"] = {n: p.numel() for n, p in
                          sliced["model"].named_parameters()
                          if n in sliced["layout"].fsdp}
    for name, remat, scan in (("drop", False, False), ("remat", True, False),
                              ("remat_scan", True, True)):
        r = _step(cfg_drop, init, mesh, batch, False, gen_seed=5, remat=remat,
                  remat_scan=scan)
        res[name] = {k: r[k] for k in ("loss", "gnorm", "params", "grads")}

    # planted faults: the gradients averaged over the data group, and the
    # loss's batch statistics left on each rank
    orig_reduce = sharding.Layout.reduce_grads

    def averaged(self, grads):
        return {n: g / self.mesh.data
                for n, g in orig_reduce(self, grads).items()}

    sharding.Layout.reduce_grads = averaged
    try:
        r = _step(cfg, init, mesh, batch, False)
        res["fault_avg"] = {k: r[k] for k in ("loss", "gnorm", "params")}
    finally:
        sharding.Layout.reduce_grads = orig_reduce
    from spann3r_torch import losses
    orig_sum = losses.all_reduce_sum
    losses.all_reduce_sum = lambda x, group: x
    try:
        r = _step(cfg, init, mesh, batch, False)
        res["fault_local"] = {k: r[k] for k in ("loss", "gnorm", "params")}
    finally:
        losses.all_reduce_sum = orig_sum

    # gradient accumulation over two global batches
    model, layout = _fresh(cfg, init, mesh, False)
    opt = TT.make_optimizer(WD)
    st = opt.init(dict(model.named_parameters()))
    _, gstep, apply = TT.make_accum_train_step(cfg, TC.FP32, opt, 2,
                                               grads_bf16=False, layout=layout)
    acc = TT.zero_grads(model, layout)
    for seed in (1, 2):
        acc, _ = gstep(model, acc, rows(global_batch(seed), mesh.data_rank,
                                        mesh.data), None, ALPHA)
    st, _, gn = apply(model, st, acc, LR)
    res["accum"] = {"gnorm": float(gn), "params": _full_weights(model, layout),
                    "mu": layout.full_tensors(st.mu)}

    # the rank-strided eval (3/2 split), and a set smaller than the world
    eval_step = TT.make_eval_step(cfg, TC.FP32)
    with sliced["layout"].gathered(sliced["model"]):
        for n in (5, 1):
            t0 = time.time()
            res[f"eval{n}"] = TT.test_one_epoch(
                eval_step, sliced["model"], build_dataset(EVAL_SET.format(n=n)),
                1, mesh=mesh)
            res[f"eval{n}_s"] = time.time() - t0

    # a checkpoint written under --fsdp 1, resumed under --fsdp 0
    ckpt = TT.CheckpointManager(os.path.join(out, "ckpt"))
    ckpt.save("last", sliced["model"], sliced["state"], 3, 1.25, None,
              sliced["layout"])
    full = ckpt.restore("last")
    model, layout = _fresh(cfg, full["model"], mesh, False)
    st = TT._opt_state_to(full["optimizer"], "cpu", layout)
    res["resumed"] = {"params": _full_weights(model, layout),
                      "mu": layout.full_tensors(st.mu),
        "nu": layout.full_tensors(st.nu), "count": int(st.count)}
    res["saved_nu"] = sliced["layout"].full_tensors(sliced["state"].nu)

    # the meters' sum over the processes
    from spann3r_torch.utils.metrics import SmoothedValue
    meter = SmoothedValue()
    for v in range(mesh.rank + 1):
        meter.update(float(v + 1))
    meter.synchronize_between_processes()
    res["meter"] = (meter.count, meter.total)

    # the CLI's epoch loop under torchrun's environment, then its resume
    args = TT.get_args_parser().parse_args([
        "--device", "cpu", "--resolution", "32", "--head_type", "linear",
        "--num_frames", "3", "--batch_size", "2", "--epochs", "1",
        "--warmup_epochs", "0", "--print_freq", "1", "--num_workers", "1",
        "--keep_freq", "0", "--bf16", "0", "--fsdp", "1", "--tp_min_dim",
        "32", "--output_dir", os.path.join(out, "cli"),
        "--train_dataset", f"4 @ {TRAIN_SET}",
        "--test_dataset", EVAL_SET.format(n=3)])
    r1 = TT.train(args, model_cfg=cfg)
    args.epochs = 2
    r2 = TT.train(args, model_cfg=cfg)
    res["cli"] = {"count1": int(r1["opt_state"].count),
                  "count2": int(r2["opt_state"].count),
                  "last_loss": r2["last_loss"]}
    return res


def _model2(mesh, out, init):
    cfg = tiny_cfg(TC)
    r = _step(cfg, init, mesh, global_batch(0), False)
    res = _public(r)
    res["tp"] = dict(r["layout"].tp)
    # the split in float64 against one process in float64
    p64 = TC.Precision(compute_dtype=torch.float64, head_dtype=torch.float64)
    batch = {k: torch.from_numpy(v).double() if v.dtype.kind == "f"
             else torch.from_numpy(v) for k, v in global_batch(0).items()}
    grads = []
    for split in (False, True):
        model = TS.build_spann3r(cfg, "cpu")
        model.load_state_dict(init)
        model.double()
        layout = None
        if split:
            layout = sharding.Layout(model, cfg, mesh, False, min_dim=32)
            layout.shard_model_(model)
        _, _, g = TT.value_and_grad(model, cfg, p64, batch, None, ALPHA,
                                    layout=layout)
        grads.append(g if layout is None
                     else layout.full_tensors(layout.reduce_grads(g)))
    gmax = max(float(g.abs().max()) for g in grads[0].values())
    res["f64_err"] = max(float((grads[1][k] - g).abs().max())
                         for k, g in grads[0].items()) / gmax

    # the CLI's epoch loop with every block split, its eval and checkpoint
    # under tensor parallelism, then its resume
    args = TT.get_args_parser().parse_args([
        "--device", "cpu", "--resolution", "32", "--head_type", "linear",
        "--num_frames", "3", "--batch_size", "2", "--epochs", "1",
        "--warmup_epochs", "0", "--print_freq", "1", "--num_workers", "1",
        "--keep_freq", "0", "--bf16", "0", "--model_axis", "2",
        "--tp_min_dim", "32", "--output_dir", os.path.join(out, "cli_tp"),
        "--train_dataset", f"4 @ {TRAIN_SET}",
        "--test_dataset", EVAL_SET.format(n=3)])
    r1 = TT.train(args, model_cfg=cfg)
    args.epochs = 2
    r2 = TT.train(args, model_cfg=cfg)
    res["cli"] = {"count1": int(r1["opt_state"].count),
                  "count2": int(r2["opt_state"].count),
                  "last_loss": r2["last_loss"], "split": len(r2["layout"].tp),
                  "params": _full_weights(r2["model"], r2["layout"])}
    return res


def _dm22(mesh, out, init):
    return _public(_step(tiny_cfg(TC), init, mesh, global_batch(0), True))


SCENARIOS = {"data2": (1, _data2), "model2": (2, _model2),
             "dm22": (2, _dm22)}


def worker(scenario, out):
    torch.set_num_threads(1)
    pmesh.init_distributed("cpu")
    model_axis, fn = SCENARIOS[scenario]
    mesh = pmesh.make_mesh(model_axis)
    init = torch.load(os.path.join(out, "init.pt"))
    res = fn(mesh, out, init)
    res.update(rank=mesh.rank, data_rank=mesh.data_rank,
               model_rank=mesh.model_rank)
    torch.save(res, os.path.join(out, f"{scenario}_{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()
    print("WORKER_OK", mesh.rank, flush=True)


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(scenario, world, out):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        log = open(out / f"{scenario}_{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_distributed", "worker",
             scenario, str(out)], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, out, scenario):
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
    results = []
    for rank, (p, _) in enumerate(procs):
        text = (out / f"{scenario}_{rank}.log").read_text()
        assert p.returncode == 0 and f"WORKER_OK {rank}" in text, \
            f"{scenario} rank {rank} failed:\n{text[-4000:]}"
        results.append(torch.load(out / f"{scenario}_{rank}.pt",
                                  weights_only=False))
    return results


def _close(got, want, rel, scale=None):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if scale is None else scale
    return bool(np.all(np.abs(got - want) <= rel * max(scale, 1e-12)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario's per-rank results, and the one-process references
    computed here while the workers run."""
    import jax
    import jax.numpy as jnp

    from spann3r_tpu import config as JC
    from spann3r_tpu import training as JT
    from spann3r_tpu.models import spann3r as JS
    from spann3r_torch.utils import convert

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("dist")
    params = JS.init_spann3r(jax.random.PRNGKey(1), tiny_cfg(JC))
    pnp = jax.tree.map(np.asarray, params)
    init = convert.state_dict_from_jax_params(pnp, tiny_cfg(TC))
    torch.save(init, out / "init.pt")
    procs = {s: _launch(s, w, out) for s, w in
             (("data2", 2), ("model2", 2), ("dm22", 4))}
    try:
        def as_port(tree):
            return convert.state_dict_from_jax_params(
                jax.tree.map(np.asarray, tree), tiny_cfg(TC))

        ref = {"init": init}
        jopt = JT.make_optimizer(WD)
        jstep = JT.make_train_step(tiny_cfg(JC), JC.FP32, jopt, remat=False,
                                   grads_bf16=False)
        b0 = global_batch(0)
        jp, js, jm = jstep(params, jopt.init(params),
                           {k: jnp.asarray(v) for k, v in b0.items()},
                           jax.random.PRNGKey(0), jnp.float32(LR),
                           jnp.float32(ALPHA))
        ref["jax"] = {"loss": float(jm["loss"]),
                      "gnorm": float(jm["grad_norm"]),
                      "params": as_port(jp), "mu": as_port(js.mu)}
        _, jgrad, japply = JT.make_accum_train_step(
            tiny_cfg(JC), JC.FP32, jopt, 2, remat=False, grads_bf16=False)
        acc = jax.tree.map(jnp.zeros_like, params)
        for i, seed in enumerate((1, 2)):
            acc, _ = jgrad(params, acc, {k: jnp.asarray(v) for k, v in
                                         global_batch(seed).items()},
                           jax.random.PRNGKey(i), jnp.float32(ALPHA))
        ap, ast, _, agn = japply(params, jopt.init(params), acc,
                                 jnp.float32(LR))
        ref["jax_accum"] = {"gnorm": float(agn), "params": as_port(ap),
                            "mu": as_port(ast.mu)}

        # the port in one process on the concatenated batch, dropout on
        cfg_drop = tiny_cfg(TC, dropout=0.15)
        model = TS.build_spann3r(cfg_drop, "cpu")
        model.load_state_dict(init)
        _, _, grads = TT.value_and_grad(
            model, cfg_drop, TC.FP32, TT.batch_to_device(b0, "cpu"),
            torch.Generator().manual_seed(5), ALPHA)
        opt = TT.make_optimizer(WD)
        st, m = TT.make_train_step(cfg_drop, TC.FP32, opt, grads_bf16=False)(
            model, opt.init(dict(model.named_parameters())), b0,
            torch.Generator().manual_seed(5), LR, ALPHA)
        ref["drop"] = {"loss": float(m["loss"]), "grads": grads, "params": {
            k: v.detach().clone() for k, v in model.named_parameters()}}
        results = {s: _wait(p, out, s) for s, p in procs.items()}
    finally:
        for plist in procs.values():
            for p, log in plist:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        torch.set_num_threads(n)
    return ref, results, out


def _check_updates(new, old, want_new, mu):
    from tests.test_torch_training import _check_updates as check
    check({k: v.detach() for k, v in new.items()}, old, want_new, mu)


LAYOUTS = [("data2", "fsdp0"), ("data2", "fsdp1"), ("model2", None),
           ("dm22", None)]


def _result(results, scenario, key):
    return [r if key is None else r[key] for r in results[scenario]]


@pytest.mark.parametrize("scenario,key", LAYOUTS)
def test_step_matches_jax_on_the_global_batch(runs, scenario, key):
    """Each layout's step on the ranks' parts against JAX's one-process
    step on the whole batch: the loss the same on every rank and within
    1e-4 of JAX's, the grad norm within 1e-4, the moments within 1e-4 of
    their largest, the updated weights within `_check_updates`."""
    ref, results, _ = runs
    want = ref["jax"]
    per_rank = _result(results, scenario, key)
    assert len({r["loss"] for r in per_rank}) == 1
    assert len({r["gnorm"] for r in per_rank}) == 1
    got = per_rank[0]
    assert _close(got["loss"], want["loss"], 1e-4)
    assert _close(got["gnorm"], want["gnorm"], 1e-4)
    mmax = max(float(v.abs().max()) for v in want["mu"].values())
    for k, v in want["mu"].items():
        assert _close(got["mu"][k], v.numpy(), 1e-4, mmax), k
    _check_updates(got["params"], ref["init"], want["params"], want["mu"])
    for r in per_rank[1:]:
        for k, v in r["params"].items():
            assert torch.equal(v, got["params"][k]), k


def test_model_ranks_agree_on_the_replicated_gradients(runs):
    """Under --model_axis 2 the tensors that stay whole get the same
    gradient on both model ranks, bit for bit; the split ones differ."""
    _, results, _ = runs
    for scenario in ("model2", "dm22"):
        rs = results[scenario]
        for d in range(2 if scenario == "dm22" else 1):
            a, b = [r for r in rs if r["data_rank"] == d]
            assert a["replicated"] and set(a["replicated"]) == set(
                b["replicated"])
            for k, v in a["replicated"].items():
                assert torch.equal(v, b["replicated"][k]), k
    assert not torch.equal(results["model2"][0]["qkv"],
                           results["model2"][1]["qkv"])


def test_tensor_parallel_is_exact_in_float64(runs):
    """The Megatron split changes only the order of sums: in float64 the
    model-2 gradients are the one-process gradients within 1e-12 of the
    largest (the FP32 bounds above, and chip_smoke's, are rounding)."""
    _, results, _ = runs
    for r in results["model2"]:
        assert r["f64_err"] < 1e-12


def test_qkv_split_by_heads(runs):
    """Each model rank holds its heads' rows of q, of k and of v of the
    packed (3, H, Dh) projection, not a contiguous third."""
    ref, results, _ = runs
    full = ref["init"]["dust3r.enc_blocks.0.attn.qkv.weight"]   # (192, 64)
    heads = full.view(3, 4, 16, 64)
    for r in results["model2"]:
        want = heads[:, 2 * r["model_rank"]:2 * r["model_rank"] + 2]
        assert r["qkv"].shape == (96, 64)
        assert torch.equal(r["qkv"], want.reshape(96, 64))
        assert r["tp"]["dust3r.enc_blocks.0.attn.qkv.weight"] == "qkv"
        assert r["tp"]["dust3r.dec_blocks2.1.cross_attn.proj.weight"] == "cols"
    parts = [sharding.tp_slice(full, "qkv", i, 2) for i in range(2)]
    assert torch.equal(sharding.tp_join(parts, "qkv"), full)


def test_fsdp_slices_are_ceil_numel_over_n(runs):
    ref, results, _ = runs
    for r in results["data2"]:
        sizes = r["slice_numel"]
        assert sizes
        for name, k in sizes.items():
            assert k == -(-ref["init"][name].numel() // 2), name
    t = torch.arange(7.0)
    parts = [pmesh.flat_shard(t, i, 3) for i in range(3)]
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4, 5], [6, 0, 0]]


def test_dropout_on_matches_one_process_on_the_whole_batch(runs):
    """Memory dropout drawn for the whole batch: data 2 gives what one
    process gives on the concatenated batch with the same seed. The loss
    within 1e-6 relative, every gradient within 1e-6 of the largest |grad|;
    the updated weights within 1e-6 of the largest update, plus one fp32
    spacing of the weight, where the gradient is above 1e-3 of the
    largest. Below that the first Adam step, g / (|g| + 1e-8) after the
    clip, turns the gradients' rounding (up to 1e-6 of the largest, a
    large part of a small gradient) into a visible part of the update, and
    a weight whose gradient is ~1e-8 moves by anything up to lr: there the
    bound is `_check_updates`' 2 * lr * (1 + wd * |w|)."""
    ref, results, _ = runs
    want = ref["drop"]
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    upd = max(float((want["params"][k] - v).abs().max())
              for k, v in ref["init"].items())
    for r in results["data2"]:
        got = r["drop"]
        assert abs(got["loss"] - want["loss"]) <= SAME_TOL * abs(want["loss"])
        for k, g in want["grads"].items():
            assert float((got["grads"][k] - g).abs().max()) <= \
                SAME_TOL * gmax, k
            w0 = ref["init"][k].numpy()
            err = np.abs(got["params"][k].numpy()
                         - want["params"][k].numpy())
            ulp = np.spacing(np.maximum(np.abs(w0), np.abs(
                want["params"][k].numpy())).astype(np.float32))
            sure = np.abs(g.numpy()) > 1e-3 * gmax
            assert (err[sure] <= SAME_TOL * upd + ulp[sure]).all(), k
            assert (err <= 2 * LR * (1 + WD * np.abs(w0)) + ulp).all(), k


@pytest.mark.parametrize("setting", ["remat", "remat_scan"])
def test_remat_gives_the_same_bits_at_data_2(runs, setting):
    _, results, _ = runs
    for r in results["data2"]:
        assert r[setting]["loss"] == r["drop"]["loss"]
        assert r[setting]["gnorm"] == r["drop"]["gnorm"]
        for k, v in r["drop"]["params"].items():
            assert torch.equal(r[setting]["params"][k], v), k


@pytest.mark.parametrize("fault", ["fault_avg", "fault_local"])
def test_planted_faults_fail_the_bounds(runs, fault):
    """Gradients averaged over the data group, or the loss's batch
    statistics left on each rank, fall outside the bounds the layouts
    meet."""
    ref, results, _ = runs
    want = ref["jax"]
    r = results["data2"]
    loss_ok = all(_close(x[fault]["loss"], want["loss"], 1e-4) for x in r)
    gnorm_ok = all(_close(x[fault]["gnorm"], want["gnorm"], 1e-4) for x in r)
    assert not (loss_ok and gnorm_ok)


def test_accumulated_step_matches_jax(runs):
    ref, results, _ = runs
    want = ref["jax_accum"]
    for r in results["data2"]:
        got = r["accum"]
        assert _close(got["gnorm"], want["gnorm"], 1e-4)
        _check_updates(got["params"], ref["init"], want["params"],
                       want["mu"])


@pytest.mark.parametrize("n", [5, 1])
def test_rank_strided_eval_equals_one_process(runs, n):
    """The 5-item set splits 3/2 over the data ranks, the 1-item set leaves
    rank 1 empty (it must still enter every gather); the merged stats on
    every rank equal one process's eval of the weights after the step."""
    ref, results, _ = runs
    cfg = tiny_cfg(TC)
    model = TS.build_spann3r(cfg, "cpu")
    model.load_state_dict(results["data2"][0]["fsdp1"]["params"])
    want = TT.test_one_epoch(TT.make_eval_step(cfg, TC.FP32), model,
                             build_dataset(EVAL_SET.format(n=n)), 1)
    for r in results["data2"]:
        got = r[f"eval{n}"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_checkpoint_loads_under_other_layouts(runs):
    """Written at data 2 under --fsdp 1 (every rank gathers, rank 0
    writes): full tensors, read in one process (its eval equals the merged
    eval) and resumed at data 2 under --fsdp 0 with the same weights and
    moments."""
    from spann3r_torch.utils import convert

    ref, results, out = runs
    ck = convert.read_checkpoint(str(out / "ckpt" / "checkpoint-last.pth"))
    assert ck["epoch"] == 3 and ck["best_so_far"] == 1.25
    saved = results["data2"][0]["fsdp1"]
    for k, v in ref["init"].items():
        assert ck["model"][k].shape == v.shape
        assert torch.equal(ck["model"][k], saved["params"][k]), k
        assert torch.equal(ck["optimizer"]["mu"][k], saved["mu"][k]), k
    cfg = tiny_cfg(TC)
    model = TS.build_spann3r(cfg, "cpu")
    model.load_state_dict(ck["model"])
    stats = TT.test_one_epoch(TT.make_eval_step(cfg, TC.FP32), model,
                              build_dataset(EVAL_SET.format(n=5)), 1)
    for k in ("loss_avg", "loss_med"):
        np.testing.assert_allclose(stats[k], results["data2"][0]["eval5"][k],
                                   rtol=1e-5)
    for r in results["data2"]:
        res = r["resumed"]
        assert res["count"] == 1
        for k, v in ck["model"].items():
            assert torch.equal(res["params"][k], v), k
            assert torch.equal(res["mu"][k], ck["optimizer"]["mu"][k]), k
            assert torch.equal(res["nu"][k], r["saved_nu"][k]), k


def test_meters_sum_over_the_processes(runs):
    _, results, _ = runs
    for r in results["data2"]:
        assert r["meter"] == (3, 1.0 + 1.0 + 2.0)


def test_cli_trains_and_resumes_at_world_2(runs):
    """train() under torchrun's environment at data 2 with --fsdp 1: one
    step an epoch (4 clips, B = 2 a rank), the eval under the mesh, one
    writer (rank 0) for log.txt and checkpoint-last.pth, and the resume
    from it on every rank."""
    _, results, out = runs
    for r in results["data2"]:
        assert r["cli"]["count1"] == 1 and r["cli"]["count2"] == 2
        assert np.isfinite(r["cli"]["last_loss"])
    lines = [json.loads(x) for x in open(out / "cli" / "log.txt")]
    assert [x["epoch"] for x in lines] == [0, 0, 1, 1, 1, 2]
    assert "test_SynthRoom_loss_med" in lines[2]
    ck = __import__("spann3r_torch.utils.convert", fromlist=["x"]) \
        .read_checkpoint(str(out / "cli" / "checkpoint-last.pth"))
    assert ck["epoch"] == 1 and int(ck["optimizer"]["count"]) == 2
    logs = [(out / f"data2_{r}.log").read_text() for r in (0, 1)]
    assert all("auto-resumed from epoch 1" in t for t in logs)
    assert all("sharded params:" in t for t in logs)


def test_cli_trains_and_resumes_under_tensor_parallelism(runs):
    """train() at world 2 with --model_axis 2 (every block split, one data
    rank, two steps an epoch): the eval and the checkpoint under tensor
    parallelism, rank 0 the one writer of full tensors, the resume on both
    ranks, and both model ranks ending with the same full weights."""
    from spann3r_torch.utils import convert

    ref, results, out = runs
    a, b = results["model2"]
    for r in (a, b):
        assert r["cli"]["count1"] == 2 and r["cli"]["count2"] == 4
        assert r["cli"]["split"] > 0 and np.isfinite(r["cli"]["last_loss"])
    for k, v in a["cli"]["params"].items():
        assert torch.equal(v, b["cli"]["params"][k]), k
    lines = [json.loads(x) for x in open(out / "cli_tp" / "log.txt")]
    assert [x["epoch"] for x in lines] == [0, 0, 1, 1, 1, 2]
    assert np.isfinite(lines[2]["test_SynthRoom_loss_med"])
    ck = convert.read_checkpoint(str(out / "cli_tp" / "checkpoint-last.pth"))
    assert ck["epoch"] == 1 and int(ck["optimizer"]["count"]) == 4
    for k, v in ref["init"].items():
        assert ck["model"][k].shape == v.shape, k
        assert ck["optimizer"]["mu"][k].shape == v.shape, k
        assert torch.equal(ck["model"][k], a["cli"]["params"][k]), k
    logs = [(out / f"model2_{r}.log").read_text() for r in (0, 1)]
    assert all("auto-resumed from epoch 1" in t for t in logs)
    assert all("split over model (2)" in t for t in logs)


# ---------------------------------------------------------------------------
# the eval merge against JAX's
# ---------------------------------------------------------------------------

DETAIL_NAMES = ("conf_loss_1", "conf_loss_2", "conf_mean", "loss_pts3d_1",
                "loss_pts3d_2")


def _threaded_merge(merge, per_rank):
    """merge(losses, details, world, gather_fn) run on one thread a rank,
    gather_fn an all-gather among the threads (each call stacks the
    ranks' arrays of the same call). A rank that leaves out a gather its
    peers enter breaks the barrier. Returns each rank's result."""
    import threading

    world = len(per_rank)
    barrier = threading.Barrier(world, timeout=30)
    slots, out, errors = {}, [None] * world, []

    def run(r):
        calls = [0]

        def gather(a):
            slots[(calls[0], r)] = np.asarray(a)
            barrier.wait()
            got = np.stack([slots[(calls[0], q)] for q in range(world)])
            barrier.wait()
            calls[0] += 1
            return got

        losses, details = per_rank[r]
        try:
            out[r] = merge(list(losses), dict(details), world,
                           gather_fn=gather)
        except Exception as e:            # reported below, on the main thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return out


@pytest.mark.parametrize("sizes", [(3, 2), (2, 0), (2, 1, 0)],
                         ids=["3-2", "empty-rank", "world-3"])
def test_merge_eval_stats_matches_jax(sizes):
    """The port's `_merge_eval_stats` and JAX's on the same per-rank batch
    losses and detail sums, every gather a real exchange between the
    ranks: the ragged 3/2 split, a rank with an empty part of the set (no
    losses, no detail names), and three ranks. Every rank of both gets the
    same statistics, equal to the bit."""
    from spann3r_tpu import training as JT

    rng = np.random.default_rng(sum(sizes))
    per_rank = []
    for n in sizes:
        losses = rng.uniform(0.1, 3.0, n).astype(np.float32).tolist()
        details = {k: float(rng.uniform(0.0, n)) for k in DETAIL_NAMES} \
            if n else {}
        per_rank.append((losses, details))
    got = _threaded_merge(TT._merge_eval_stats, per_rank)
    want = _threaded_merge(JT._merge_eval_stats, per_rank)
    assert set(want[0]) == {"loss_avg", "loss_med", *DETAIL_NAMES}
    for g, w in zip(got, want):
        assert g == w == want[0]
    n = sum(sizes)
    assert want[0]["loss_pts3d_1"] == pytest.approx(
        sum(d.get("loss_pts3d_1", 0.0) for _, d in per_rank) / n, rel=1e-6)


def test_make_mesh_needs_model_to_divide_the_world():
    with pytest.raises(ValueError, match="--model_axis 2 .* world size 1"):
        pmesh.make_mesh(2)
    mesh = pmesh.make_mesh(1)
    assert (mesh.data, mesh.model, mesh.rank, mesh.distributed) == \
        (1, 1, 0, False)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2], sys.argv[3])
