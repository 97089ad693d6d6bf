"""The weights of each configuration file, bit for bit as the benchmark
drew them before the model kinds moved into benchmark/models/: the
sha256 of `weights.spec`'s (name, shape, rule) list at full size, and of
`weights.generate`'s tensors on the CPU at the CPU tests' cut
(tiny.cell), for two seeds. A change here changes what every run of the
configuration's cells computes."""
from __future__ import annotations

import hashlib
import json

import pytest

from benchmark import run, weights as bw
from benchmark.tests import tiny

SEEDS = (1, 2**31 + 7)
# configuration file: (cell, spec at full size, parameters, spec at the
# cut, weights at the cut for each seed)
WANT = {
    "benchmark/configs/spann3r.json": (
        "spann3r.online-512",
        "c427322318cb20b7d8e8f62664e889b7324366d8b792267ea5f76724e22407d2", 658691208,
        "1a1e54e4ee5ed511e600634add42597e4651d587414a54535d40b5d664412c2f",
        ("4b93967f94990d1470aa2687109bbadffbb0a1beb61b2cae01e03097c0903d88",
         "5f5a182506e978011acc98dce4b6e489558211cdb5d303d6a0374f0dad080773")),
    "benchmark/configs/dust3r-512-dpt.json": (
        "dust3r.pairs-512",
        "3723c31e8c3e9d694e8ad93503d5350c9c7de6b132d6204ca7eb86ce5ea6af4d", 571170440,
        "b69fce318abc350b20357505f4940913d64597197bcc457dc306a0c3b26390ce",
        ("d38c9aad9a15597063d6343debc81f3e6c43163cfc79b7ff1f92d2b8dae9b11d",
         "d60d45ff20926e7de94451096b63f8d60f50127ef8deb0950499baee3f035208")),
}


def spec_sha(cfg: dict) -> str:
    rows = [[n, list(s), r] for n, s, r in bw.spec(cfg)]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def weights_sha(cfg: dict, seed: int) -> str:
    h = hashlib.sha256()
    for name, t in bw.generate(cfg, seed, "cpu").items():
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("file", sorted(WANT))
def test_spec_at_full_size(file):
    _, want, n, _, _ = WANT[file]
    cfg = json.loads((run.ROOT / file).read_text())
    assert spec_sha(cfg) == want and bw.n_params(cfg) == n


@pytest.mark.parametrize("file", sorted(WANT))
@pytest.mark.parametrize("seed", range(len(SEEDS)))
def test_weights_at_the_cut(file, seed):
    cell, _, _, want_spec, want = WANT[file]
    cfg, _ = tiny.cell(cell)
    assert spec_sha(cfg) == want_spec
    assert weights_sha(cfg, SEEDS[seed]) == want[seed]

