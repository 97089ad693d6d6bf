"""Plain fp32 reference of Spann3R and of its DUSt3R backbone, in PyTorch.

Functional over a dict of named weights, whose names are the published
checkpoints' keys (`dust3r.enc_blocks.0.attn.qkv.weight`, ...). It follows
the published architecture (DUSt3R's `AsymmetricCroCo3DStereo` with the
512-DPT head, Spann3R's `spann3r/model.py`) and the
memory semantics the system under test states: cosine dedup against the
working memory, working -> long-term spill, usage-based pruning, the
thresholded read. No kernel and no batching trick: every product is a
plain fp32 `torch.matmul` or convolution (TF32 off, set by the caller).
What depends on the weights or the image size alone is made once per
`Ref` and kept (`cache=True`): the RoPE tables of each grid of positions
and, where the products' operands are rounded, the rounded weights. The
outputs are the same bits with the cache off.

`lowp=True` rounds the inputs and weights of every linear layer and of the
attention products to float8 e4m3 (one scale per tensor): the precision
below bfloat16 that a later change could be tempted by. The benchmark's
control runs it to show that the comparison rejects it. `bf16=True`
rounds the same operands to bfloat16, the configuration's own transformer
precision, and leaves the heads' convolutions in fp32 as the
configuration does: where sound rounding lands with no program code
involved, a twin that must pass the comparison.

This file imports nothing of the program and no JAX.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
FP8_MAX = 448.0


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in fp32."""
    return x.to(torch.bfloat16).float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor, back in
    fp32."""
    s = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Ref:
    """The model's weights (fp32, on the device the reference runs on) and
    its sizes (the configuration file's keys)."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: dict,
                 lowp: bool = False, bf16: bool = False, cache: bool = True):
        self.w = weights
        self.cfg = cfg
        self.round = fp8 if lowp else bf16_round if bf16 else None
        # the backbone's keys sit under "dust3r." inside Spann3R
        self.p = "dust3r." if cfg["model"] == "spann3r" else ""
        self.cache = cache
        # each linear layer's weight, transposed and rounded, as `linear`
        # multiplies it (the 2-D weights are the linear layers')
        self.wt = ({n: self.round(t.t()) for n, t in weights.items() if t.dim() == 2}
                   if cache and self.round is not None else {})
        # positions by (batch, grid, device), and the RoPE tables of each
        self.pos: Dict[tuple, torch.Tensor] = {}
        self.tables: Dict[tuple, list] = {}

    # -- primitives ----------------------------------------------------------

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.round is not None:
            a, b = self.round(a), self.round(b)
        return torch.matmul(a, b)

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        wt = self.wt.get(name + ".weight")
        y = (self.mm(x, self.w[name + ".weight"].t()) if wt is None
             else torch.matmul(self.round(x), wt))
        b = self.w.get(name + ".bias")
        return y if b is None else y + b

    def ln(self, name: str, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w[name + ".weight"],
                            self.w[name + ".bias"], eps)

    def conv(self, name: str, x: torch.Tensor, stride: int = 1,
             padding: int = 0) -> torch.Tensor:
        return F.conv2d(x, self.w[name + ".weight"], self.w.get(name + ".bias"),
                        stride=stride, padding=padding)

    def conv_t(self, name: str, x: torch.Tensor, stride: int) -> torch.Tensor:
        return F.conv_transpose2d(x, self.w[name + ".weight"],
                                  self.w.get(name + ".bias"), stride=stride)

    # -- attention -------------------------------------------------------------

    @staticmethod
    def rope_tables(pos: torch.Tensor, q: int, base: float) -> list:
        """Per axis (y, then x), cos and sin of each position's angles,
        (B, 1, N, q) for positions (B, N, 2)."""
        inv = 1.0 / (base ** (torch.arange(q, dtype=torch.float32,
                                           device=pos.device) / q))
        out = []
        for axis in (0, 1):
            ang = pos[..., axis].float()[:, None, :, None] * inv
            out.append((torch.cos(ang), torch.sin(ang)))
        return out

    def rope(self, t: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
        """RoPE2D on (B, H, N, D): the first half of D rotates with the
        y position, the second with x, each half as rotate-half pairs.
        The tables of positions that `patch_embed` made are kept."""
        d = t.shape[-1]
        q = d // 4
        key = (id(pos), q, base)
        tables = self.tables.get(key)
        if tables is None:
            tables = self.rope_tables(pos, q, base)
            # the positions this reference holds keep their id
            if any(pos is p for p in self.pos.values()):
                self.tables[key] = tables
        out = []
        for (cos, sin), part in zip(tables, (t[..., :d // 2], t[..., d // 2:])):
            u, v = part[..., :q], part[..., q:]
            out += [u * cos - v * sin, v * cos + u * sin]
        return torch.cat(out, dim=-1)

    def attend(self, q, k, v):
        """softmax(q k^T / sqrt(d)) v over (B, H, N, D)."""
        s = self.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        return self.mm(torch.softmax(s, dim=-1), v)

    def self_attn(self, name, x, pos, heads, rope):
        b, n, c = x.shape
        qkv = self.linear(name + ".qkv", x).reshape(b, n, 3, heads, c // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        if rope > 0 and pos is not None:
            q, k = self.rope(q, pos, rope), self.rope(k, pos, rope)
        o = self.attend(q, k, v).transpose(1, 2).reshape(b, n, c)
        return self.linear(name + ".proj", o)

    def cross_attn(self, name, x, y, xpos, ypos, heads, rope):
        b, n, c = x.shape
        split = lambda t: t.reshape(b, t.shape[1], heads, c // heads).transpose(1, 2)
        q = split(self.linear(name + ".projq", x))
        k = split(self.linear(name + ".projk", y))
        v = split(self.linear(name + ".projv", y))
        if rope > 0:
            q, k = self.rope(q, xpos, rope), self.rope(k, ypos, rope)
        o = self.attend(q, k, v).transpose(1, 2).reshape(b, n, c)
        return self.linear(name + ".proj", o)

    def mlp(self, name, x):
        return self.linear(name + ".fc2", F.gelu(self.linear(name + ".fc1", x)))

    def block(self, name, x, pos, heads, rope):
        x = x + self.self_attn(name + ".attn", self.ln(name + ".norm1", x),
                               pos, heads, rope)
        return x + self.mlp(name + ".mlp", self.ln(name + ".norm2", x))

    def dec_block(self, name, x, y, xpos, ypos, heads, rope):
        x = x + self.self_attn(name + ".attn", self.ln(name + ".norm1", x),
                               xpos, heads, rope)
        y_ = self.ln(name + ".norm_y", y)
        x = x + self.cross_attn(name + ".cross_attn", self.ln(name + ".norm2", x),
                                y_, xpos, ypos, heads, rope)
        return x + self.mlp(name + ".mlp", self.ln(name + ".norm3", x))

    # -- DUSt3R ----------------------------------------------------------------

    def patch_embed(self, name, img):
        """img (B, H, W, C) -> tokens (B, N, D), positions (B, N, 2) (y, x)."""
        ps = self.cfg["patch_size"]
        x = self.conv(name, img.permute(0, 3, 1, 2), stride=ps)
        b, _, hp, wp = x.shape
        key = (b, hp, wp, img.device)
        pos = self.pos.get(key)
        if pos is None:
            ys, xs = torch.meshgrid(torch.arange(hp, device=img.device),
                                    torch.arange(wp, device=img.device),
                                    indexing="ij")
            pos = torch.stack([ys, xs], -1).reshape(1, -1, 2).expand(b, -1, -1)
            if self.cache:
                self.pos[key] = pos
        return x.flatten(2).transpose(1, 2), pos

    def encode(self, img):
        c, p = self.cfg, self.p
        x, pos = self.patch_embed(p + "patch_embed.proj", img)
        for i in range(c["enc_depth"]):
            x = self.block(f"{p}enc_blocks.{i}", x, pos, c["enc_num_heads"],
                           c["rope_base"])
        return self.ln(p + "enc_norm", x), pos

    def hooks(self) -> Tuple[int, int, int, int]:
        d = self.cfg["dec_depth"]
        return (0, d * 2 // 4, d * 3 // 4, d)

    def decode(self, f1, f2, pos1, pos2):
        """Both decoders; each side's states at the DPT hooks: the encoder
        features, then block outputs, the last one normed."""
        c, p = self.cfg, self.p
        x1 = self.linear(p + "decoder_embed", f1)
        x2 = self.linear(p + "decoder_embed", f2)
        hk = self.hooks()
        s1, s2 = {0: f1}, {0: f2}
        for i in range(c["dec_depth"]):
            x1, x2 = (self.dec_block(f"{p}dec_blocks.{i}", x1, x2, pos1, pos2,
                                     c["dec_num_heads"], c["rope_base"]),
                      self.dec_block(f"{p}dec_blocks2.{i}", x2, x1, pos2, pos1,
                                     c["dec_num_heads"], c["rope_base"]))
            if i + 1 in hk:
                s1[i + 1], s2[i + 1] = x1, x2
        d = c["dec_depth"]
        s1[d] = self.ln(p + "dec_norm", s1[d])
        s2[d] = self.ln(p + "dec_norm", s2[d])
        return [s1[h] for h in hk], [s2[h] for h in hk]

    def _rcu(self, name, x):
        out = self.conv(name + ".conv1", torch.relu(x), padding=1)
        return self.conv(name + ".conv2", torch.relu(out), padding=1) + x

    def _fusion(self, name, x, skip):
        out = x if skip is None else x + self._rcu(name + ".resConfUnit1", skip)
        out = self._rcu(name + ".resConfUnit2", out)
        out = F.interpolate(out, size=(out.shape[2] * 2, out.shape[3] * 2),
                            mode="bilinear", align_corners=True)
        return self.conv(name + ".out_conv", out)

    def head(self, num: int, states, hw) -> Dict[str, torch.Tensor]:
        """The DPT head of side `num` on the four hook states -> pts3d
        (B, H, W, 3) and conf (B, H, W)."""
        h, w = hw
        ps = self.cfg["patch_size"]
        nh, nw = h // ps, w // ps
        d = f"{self.p}downstream_head{num}.dpt"
        maps = [t.reshape(t.shape[0], nh, nw, -1).permute(0, 3, 1, 2)
                for t in states]
        ap = d + ".act_postprocess"
        l0 = self.conv_t(ap + ".0.1", self.conv(ap + ".0.0", maps[0]), 4)
        l1 = self.conv_t(ap + ".1.1", self.conv(ap + ".1.0", maps[1]), 2)
        l2 = self.conv(ap + ".2.0", maps[2])
        l3 = self.conv(ap + ".3.1", self.conv(ap + ".3.0", maps[3]), stride=2,
                       padding=1)
        sc = d + ".scratch"
        r = [self.conv(f"{sc}.layer{i + 1}_rn", lx, padding=1)
             for i, lx in enumerate((l0, l1, l2, l3))]
        path = self._fusion(sc + ".refinenet4", r[3], None)
        path = path[:, :, :r[2].shape[2], :r[2].shape[3]]
        path = self._fusion(sc + ".refinenet3", path, r[2])
        path = self._fusion(sc + ".refinenet2", path, r[1])
        path = self._fusion(sc + ".refinenet1", path, r[0])
        out = self.conv(d + ".head.0", path, padding=1)
        out = F.interpolate(out, size=(out.shape[2] * 2, out.shape[3] * 2),
                            mode="bilinear", align_corners=True)
        out = torch.relu(self.conv(d + ".head.2", out, padding=1))
        fmap = self.conv(d + ".head.4", out).permute(0, 2, 3, 1)
        xyz = fmap[..., :3]
        dist = xyz.norm(dim=-1, keepdim=True)
        pts = xyz / dist.clamp(min=1e-8) * torch.expm1(dist)
        conf = 1.0 + torch.exp(fmap[..., 3])
        return {"pts3d": pts, "conf": conf}

    def pair(self, img1, img2):
        """DUSt3R's two-view forward: (res1, res2) in view 1's frame."""
        feats, pos = self.encode(torch.cat([img1, img2]))
        b = img1.shape[0]
        s1, s2 = self.decode(feats[:b], feats[b:], pos[:b], pos[b:])
        hw = img1.shape[1:3]
        return self.head(1, s1, hw), self.head(2, s2, hw)

    # -- Spann3R ---------------------------------------------------------------

    def attn_head(self, num, feat_enc, feat_dec):
        x = torch.cat([feat_enc, feat_dec], dim=-1)
        return self.linear(f"attn_head_{num}.2",
                           F.gelu(self.linear(f"attn_head_{num}.0", x)))

    def value(self, pts):
        """Value tokens from the reference frame's pointmap."""
        c = self.cfg
        x, _ = self.patch_embed("pos_patch_embed.proj", pts)
        for i in range(c["value_enc_depth"]):
            x = self.block(f"value_encoder.{i}", x, None, c["value_enc_heads"],
                           0.0)
        return self.linear("value_out", self.ln("value_norm", x))

    def spann3r_pair(self, fuse, feat1, feat2, pos, hw, want_res2):
        s1, s2 = self.decode(fuse, feat2, pos, pos)
        k1 = self.attn_head(1, feat1, s1[-1])
        k2 = self.attn_head(2, feat2, s2[-1])
        res1 = self.head(1, s1, hw)
        res2 = self.head(2, s2, hw) if want_res2 else None
        return res1, res2, k1, k2, self.value(res1["pts3d"]), s2


# ---------------------------------------------------------------------------
# the spatial memory
# ---------------------------------------------------------------------------

class Bank(NamedTuple):
    k: torch.Tensor        # (B, C, D)
    v: torch.Tensor
    count: torch.Tensor    # (B, C) age in frames
    attn: torch.Tensor     # (B, C) attention received
    size: torch.Tensor     # (B,) valid slots
    wm: torch.Tensor       # (B,) working-memory frames
    lm: torch.Tensor       # (B,) long-term tokens


def empty_bank(b: int, capacity: int, dim: int, device) -> Bank:
    z = lambda *s: torch.zeros(s, device=device)
    zi = lambda: torch.zeros(b, dtype=torch.long, device=device)
    return Bank(z(b, capacity, dim), z(b, capacity, dim), z(b, capacity),
                z(b, capacity), zi(), zi(), zi())


def bank_capacity(mem: dict, p: int) -> int:
    cap = mem["long_mem_size"] + (mem["work_mem_size"] + 1) * p
    return -(-cap // 128) * 128


def _valid(bank: Bank) -> torch.Tensor:
    return torch.arange(bank.k.shape[1], device=bank.k.device)[None] < bank.size[:, None]


def read(ref: Ref, bank: Bank, feat, thresh: float):
    """The memory read: attention of the normed queries over the valid
    slots; weights under `thresh` dropped and the rest renormalised.
    Returns (fused features, bank with the attention received added)."""
    q = ref.ln("norm_q", feat)
    k = ref.ln("norm_k", bank.k)
    v = ref.ln("norm_v", bank.v)
    s = ref.mm(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    s = torch.where(_valid(bank)[:, None], s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1)
    if thresh > 0:
        a = torch.where(a < thresh, torch.zeros_like(a), a)
        a = a / (a.sum(-1, keepdim=True) + 1e-12)
    has = (bank.size > 0)[:, None, None]
    out = torch.where(has, ref.mm(a, v) + feat, feat)
    attn = bank.attn + torch.where(has[:, :, 0], a.sum(1).detach(),
                                   torch.zeros_like(bank.attn))
    return out, bank._replace(attn=attn)


def append(bank: Bank, fk, fv) -> Bank:
    """Write one frame's tokens after the valid slots; older slots age."""
    b, p, _ = fk.shape
    c = bank.k.shape[1]
    start = bank.size.clamp(0, c - p)
    idx = start[:, None] + torch.arange(p, device=fk.device)
    rows = torch.arange(b, device=fk.device)[:, None]
    k, v = bank.k.clone(), bank.v.clone()
    count = bank.count + _valid(bank).float()
    attn = bank.attn.clone()
    k[rows, idx] = fk
    v[rows, idx] = fv
    count[rows, idx] = 0.0
    attn[rows, idx] = 0.0
    return bank._replace(k=k, v=v, count=count, attn=attn, size=bank.size + p)


def similarity(bank: Bank, fk) -> List[float]:
    """Per stream, the largest mean (over tokens) cosine similarity of the
    frame's keys to one frame of the working memory; -inf with none."""
    b, p, d = fk.shape
    c = bank.k.shape[1]
    out = []
    for i in range(b):
        nwm, end = int(bank.wm[i]), int(bank.size[i])
        if end == 0 or nwm == 0:
            out.append(float("-inf"))
            continue
        # the working frames are the last nwm * P slots (indices clamped
        # into the bank)
        idx = (torch.arange(nwm * p, device=fk.device) + end - nwm * p).clamp(0, c - 1)
        win = bank.k[i, idx].reshape(nwm, p, d)
        sim = F.cosine_similarity(win, fk[i][None], dim=-1, eps=1e-12)
        out.append(float(sim.mean(-1).max()))
    return out


def prune(bank: Bank, mem: dict) -> Bank:
    """Keep the long_mem_size slots of most attention per frame of age,
    slots younger than work_mem_size + 5 frames first, earlier slots
    first among equals."""
    protect = mem["work_mem_size"] + 5
    keep_n = mem["long_mem_size"]
    w = bank.attn / bank.count.clamp(min=1e-8)
    w = torch.where(bank.count < protect, torch.full_like(w, 1e8), w)
    w = torch.where(_valid(bank), w, torch.full_like(w, NEG_INF))
    idx = torch.sort(w, dim=1, descending=True, stable=True).indices[:, :keep_n]
    c = bank.k.shape[1]

    def take(a):
        g = torch.gather(a, 1, idx if a.dim() == 2 else
                         idx[..., None].expand(-1, -1, a.shape[2]))
        pad = list(g.shape)
        pad[1] = c - keep_n
        return torch.cat([g, g.new_zeros(pad)], 1)

    return bank._replace(k=take(bank.k), v=take(bank.v),
                         count=take(bank.count), attn=take(bank.attn),
                         size=torch.full_like(bank.size, keep_n))


def write(bank: Bank, fk, fv, mem: dict, dup: Optional[torch.Tensor] = None,
          log: Optional[list] = None) -> Bank:
    """The inference write: skipped for a duplicate frame; else append,
    spill the oldest working frame to long-term memory past work_mem_size
    frames, and prune when long-term memory passes long_mem_size. `dup`
    (B,) bool, when given, takes the place of the dedup decision; `log`
    receives each stream's (similarity, own decision)."""
    p = fk.shape[1]
    sims = similarity(bank, fk)
    own = torch.tensor([x > mem["sim_thresh"] for x in sims], device=fk.device)
    if log is not None:
        log.append(list(zip(sims, own.tolist())))
    dup = own if dup is None else dup.to(fk.device)
    s = append(bank, fk, fv)
    wm = s.wm + 1
    spill = wm > mem["work_mem_size"]
    s = s._replace(wm=torch.where(spill, wm - 1, wm),
                   lm=torch.where(spill, s.lm + p, s.lm))
    need = s.lm > mem["long_mem_size"]
    if bool(need.any()):
        pr = prune(s, mem)
        pr = pr._replace(lm=mem["long_mem_size"] - pr.wm * p)
        s = Bank(*(_select(need, x, a) for x, a in zip(pr, s)))
    return Bank(*(_select(dup, o, n) for o, n in zip(bank, s)))


def _select(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where the stream's pred (B,) holds, else b."""
    return torch.where(pred.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


# ---------------------------------------------------------------------------
# streaming reconstruction
# ---------------------------------------------------------------------------

def step(ref: Ref, bank: Bank, prev, feat, pos, k2, hw, dup=None, log=None):
    """One frame t >= 1 of `stream`: the read of the bank with the previous
    pair's target keys k2 (none on the first pair, which fuses prev, the
    features of frame t - 1, itself), the pair (t - 1, t) and the write
    (`write`, with `dup` and `log`). Returns (res1, bank, k2, s2): frame
    t - 1's outputs, the bank after the step, the pair's target keys and
    its decoder's target states."""
    mem = ref.cfg["memory"]
    fuse = prev
    if k2 is not None:
        fuse, bank = read(ref, bank, k2, mem["attn_thresh"])
    res1, _, k1, k2, v, s2 = ref.spann3r_pair(fuse, prev, feat, pos, hw, False)
    return res1, write(bank, k1, v + k1, mem, dup, log), k2, s2


def stream(ref: Ref, frames, on_frame, dups=None, log=None, on_step=None) -> None:
    """Spann3R's online reconstruction of B streams, a frame at a time:
    frames (T, B, H, W, 3) normalised. on_frame(t, pts3d, conf) receives
    each frame's pointmap in frame 0's coordinates: frame t - 1 as the
    reference view of pair (t - 1, t), and the last frame as the target
    view of the last pair. dups[t] (B,), when given, decides whether frame
    t's write is skipped as a duplicate (`write`). on_step(t, bank before,
    k2 before, bank after), when given, receives each step's state."""
    cfg = ref.cfg
    mem = cfg["memory"]
    t_total, b, h, w, _ = frames.shape
    ps = cfg["patch_size"]
    p = (h // ps) * (w // ps)
    bank = empty_bank(b, bank_capacity(mem, p), cfg["attn_head_out"],
                      frames.device)
    prev = k2 = s2 = None
    for t in range(t_total):
        feat, pos = ref.encode(frames[t])
        if prev is not None:
            before, k2_before = bank, k2
            res1, bank, k2, s2 = step(ref, bank, prev, feat, pos, k2, (h, w),
                                      None if dups is None else dups[t], log)
            if on_step is not None:
                on_step(t, before, k2_before, bank)
            on_frame(t - 1, res1["pts3d"], res1["conf"])
        prev = feat
    if s2 is not None:
        last = ref.head(2, s2, (h, w))
        on_frame(t_total - 1, last["pts3d"], last["conf"])
