"""What every driver shares: the run's context with its model kind and
driver, the model built by its kind with the benchmark's weights, the
host's clock, the reservoir that samples finished requests, the
comparison of two outputs, and the check of the DPT heads alone."""
from __future__ import annotations

import contextlib
import dataclasses
import math
import random
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import find
from benchmark import weights as bw

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class Ctx:
    """One run: the cell's configuration and traffic, its seed, window and
    trace flag, the device, and the process's start on the host clock."""
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    limits: Dict[str, float] = dataclasses.field(default_factory=dict)
    # readings kept for the record beside the compared ones
    notes: Dict[str, float] = dataclasses.field(default_factory=dict)

    def rng(self, salt: int) -> np.random.Generator:
        """A numpy generator for one purpose of this run, from the seed."""
        return np.random.default_rng([int(self.seed) & 0xFFFFFFFFFFFF, salt])

    @property
    def kind(self):
        """The configuration's model kind, benchmark/models/<model>.py."""
        return find("models", self.cfg["model"])

    @property
    def driver(self):
        """The traffic's driver, benchmark/drivers/<driver>.py."""
        return find("drivers", self.traffic["driver"])


def build_program_model(ctx: Ctx):
    """(the program's model on the device, holding the benchmark's weights
    for the seed, its configuration, its precision): the kind's build."""
    return ctx.kind.build(ctx)


def precision(cfg: dict):
    """The program's precision for the configuration's `precision`."""
    from spann3r_torch.config import Precision
    p = cfg["precision"]
    return Precision(compute_dtype=DTYPES[p["compute"]], head_dtype=DTYPES[p["heads"]])


def on_device(ctx: Ctx, make):
    """The module make() returns, built on the meta device, its storage
    allocated on the device, then filled with the benchmark's weights for
    the seed."""
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device=ctx.device)
    w = bw.generate(ctx.cfg, ctx.seed, ctx.device)
    model.load_state_dict(w, strict=True)
    del w
    return model.eval()


def set_tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """Keeps k items drawn uniformly, from the seed, among all offered."""

    def __init__(self, seed: int, k: int = 1):
        self.rng = random.Random(seed)
        self.k = k
        self.n = 0
        self.items = []

    def offer(self, item_fn):
        """item_fn() makes the item; it is called only when kept."""
        self.n += 1
        j = self.rng.randrange(self.n)
        if len(self.items) < self.k:
            self.items.append(item_fn())
        elif j < self.k:
            self.items[j] = item_fn()

    @property
    def item(self):
        return self.items[0] if self.items else None


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| over the whole tensor, fp64."""
    g, w = got.double(), want.double()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    return float((g - w).norm() / w.norm().clamp(min=1e-30))


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Window:
    """The measured window on the host clock: open() marks its start;
    `over` says whether its seconds have run out."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t0: Optional[float] = None

    def open(self) -> float:
        self.t0 = time.perf_counter()
        return self.t0

    @property
    def over(self) -> bool:
        return time.perf_counter() - self.t0 >= self.seconds


@contextlib.contextmanager
def patched(module, name, fn):
    """module.name replaced by fn inside the block."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, orig)


def program_head(dust3r_model, dcfg, prec):
    """The program's DPT head as a function of (side, the reference's
    hook states, (H, W))."""
    from spann3r_torch.models import dust3r as d3

    return lambda num, states, hw: d3.downstream_head(
        dust3r_model, num, d3.states_from_hooks(dcfg, states), hw, dcfg, prec)


def head_rel_err(ref, head, img1, img2) -> float:
    """The heads alone: head(side, states, hw), on the reference's fp32
    decoder states of the pairs (img1[i], img2[i]), against the
    reference's heads on the same states; the worst relative error of a
    pointmap or a confidence of either side. The comparison of the outputs
    cannot see the heads' precision under the bf16 transformer's rounding
    (PERF.md); this sees it. The drivers run it after the window, with the
    program alive."""
    hw = tuple(img1.shape[1:3])
    worst = 0.0
    with torch.no_grad():
        feats, pos = ref.encode(torch.cat([img1, img2]))
        b = img1.shape[0]
        s1, s2 = ref.decode(feats[:b], feats[b:], pos[:b], pos[b:])
        for num, states in ((1, s1), (2, s2)):
            want, got = ref.head(num, states, hw), head(num, states, hw)
            worst = max([worst] + [rel_err(got[k], want[k]) for k in ("pts3d", "conf")])
    return worst


def limited(ctx: Ctx, numbers: Dict[str, float]) -> Dict[str, tuple]:
    """{name: (reading, limit)} of each number that the traffic file gives
    a limit; the other readings go to the notes."""
    missing = sorted(set(ctx.limits) - set(numbers))
    if missing:
        raise KeyError(f"limits name numbers the check does not make: {missing}")
    ctx.notes.update({k: v for k, v in numbers.items() if k not in ctx.limits})
    return {k: (numbers[k], ctx.limits[k]) for k in ctx.limits}
