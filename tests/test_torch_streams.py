"""Multi-stream serving split over ranks (`spann3r_torch.parallel.streams`)
on the CPU: two gloo worker processes (this file run as `python -m
tests.test_torch_streams worker <dir>`, one thread each, under a timeout)
deal B = 4 streams of T = 6 frames over `make_mesh_for_batch`, two to a
rank, and gather them in stream order; the result must equal the JAX
package's single-stream scans of each stream, as
tests/test_sharded_inference.py holds its sharded scan: its configuration
(`tiny_cfg`, 32x32, FP32), its frames and its bound (2e-4 absolute, 1e-4
relative), the deferred target-frame head included. B = 3 takes a data
size of 1 (the largest divisor of 3 that two ranks hold): rank 0 takes
every stream, rank 1 none.
"""
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
from spann3r_torch.models import spann3r as TS
from spann3r_torch.parallel import mesh as pmesh
from spann3r_torch.parallel.streams import scan_streams

REPO = Path(__file__).resolve().parent.parent
HW = (32, 32)
T, B = 6, 4
ATOL, RTOL = 2e-4, 1e-4
WORKER_TIMEOUT = 240


def tiny_cfg(mod):
    """tests/test_sharded_inference.py's configuration in `mod`."""
    return mod.Spann3RConfig(
        dust3r=mod.DUSt3RConfig(img_size=HW, patch_size=16,
                                enc=mod.ViTConfig(dim=64, depth=2, num_heads=4),
                                dec=mod.ViTConfig(dim=48, depth=12, num_heads=4),
                                head_type="linear"),
        value_enc_depth=2, value_enc_dim=64, value_enc_heads=4,
        attn_head_in=64 + 48, attn_head_out=64)


def frames_of(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((T, B, *HW, 3)).astype(np.float32) * 0.3


@pytest.mark.parametrize("batch,avail,want", [
    (4, 2, 2), (3, 2, 1), (6, 4, 3), (8, 8, 8), (7, 4, 1), (1, 4, 1)])
def test_data_size_is_the_largest_divisor(batch, avail, want):
    assert pmesh.data_for_batch(batch, avail) == want


def test_one_process_mesh_and_blocks():
    mesh = pmesh.make_mesh_for_batch(5)
    assert (mesh.data, mesh.model, mesh.distributed) == (1, 1, False)
    batch = {"img": np.arange(3 * 4).reshape(3, 4), "idx": np.arange(3)}
    part = pmesh.shard_batch(pmesh.Mesh(2, 1, 1, 0, None, None), batch)
    np.testing.assert_array_equal(part["img"], batch["img"][:, 2:])
    np.testing.assert_array_equal(part["idx"], batch["idx"])


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

def worker(out):
    torch.set_num_threads(1)
    pmesh.init_distributed("cpu")
    cfg = tiny_cfg(TC)
    model = TS.build_spann3r(cfg, "cpu")
    model.load_state_dict(torch.load(os.path.join(out, "init.pt")))
    frames = frames_of()
    res = {}
    for batch in (B, 3):
        mesh = pmesh.make_mesh_for_batch(batch)
        res[batch] = None if mesh is None else dict(
            scan_streams(model, cfg, frames[:, :batch], HW, TC.FP32, mesh,
                         chunk=4), data=mesh.data)
    rank = torch.distributed.get_rank()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    print("WORKER_OK", rank, flush=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_single_streams(params, frames):
    """Each stream alone through the JAX package's scan, and its deferred
    head: [{'pts3d', 'conf', 'emitted', 'pts3d_2', 'conf_2'}]."""
    import jax
    import jax.numpy as jnp

    from spann3r_tpu import config as JC
    from spann3r_tpu.models import spann3r as JS

    cfg = tiny_cfg(JC)
    scan = jax.jit(lambda p, c, im, v: JS.scan_video_chunk(
        p, cfg, c, im, v, HW, JC.FP32))
    head = jax.jit(lambda p, hs: JS.head2_from_hooks(p, cfg, hs, HW, JC.FP32))
    refs = []
    for b in range(B):
        carry, ys = scan(params, JS.init_video_carry(cfg, HW, 1, JC.FP32),
                         jnp.asarray(frames[:, b:b + 1]), jnp.ones(T, bool))
        r2 = head(params, carry[3])
        refs.append({**{k: np.asarray(v) for k, v in ys.items()},
                     "pts3d_2": np.asarray(r2["pts3d"]),
                     "conf_2": np.asarray(r2["conf"])})
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results and the JAX references, computed here while the
    workers run."""
    import jax

    from spann3r_tpu import config as JC
    from spann3r_tpu.models import spann3r as JS
    from spann3r_torch.utils.convert import state_dict_from_jax_params

    out = tmp_path_factory.mktemp("streams")
    params = JS.init_spann3r(jax.random.PRNGKey(0), tiny_cfg(JC))
    torch.save(state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                          tiny_cfg(TC)), out / "init.pt")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        log = open(out / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_streams", "worker",
             str(out)], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    refs = _jax_single_streams(params, frames_of())
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
        text = (out / f"rank{rank}.log").read_text()
        assert p.returncode == 0 and f"WORKER_OK {rank}" in text, \
            f"rank {rank} failed:\n{text[-4000:]}"
        results.append(torch.load(out / f"rank{rank}.pt", weights_only=False))
    return results, refs


def _check_streams(got, refs):
    em = got["emitted"]
    for b, ref in enumerate(refs):
        np.testing.assert_array_equal(em, ref["emitted"])
        for k in ("pts3d", "conf"):
            np.testing.assert_allclose(got[k][em, b], ref[k][em, 0],
                                       atol=ATOL, rtol=RTOL, err_msg=k)
            np.testing.assert_allclose(got[k + "_2"][b], ref[k + "_2"][0],
                                       atol=ATOL, rtol=RTOL, err_msg=k)


def test_two_ranks_give_the_single_stream_scans(ranks):
    results, refs = ranks
    assert [r[B]["data"] for r in results] == [2, 2]
    for r in results:                # every rank holds the gathered streams
        assert r[B]["pts3d"].shape == (T, B, *HW, 3)
        assert r[B]["emitted"].tolist() == [False] + [True] * (T - 1)
        _check_streams(r[B], refs)
    np.testing.assert_array_equal(results[0][B]["pts3d"],
                                  results[1][B]["pts3d"])


def test_uneven_batch_takes_the_largest_divisor(ranks):
    results, refs = ranks
    assert results[0][3]["data"] == 1 and results[1][3] is None
    assert results[0][3]["pts3d"].shape == (T, 3, *HW, 3)
    _check_streams(results[0][3], refs[:3])


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
