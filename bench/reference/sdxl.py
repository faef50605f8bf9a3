"""Plain PyTorch reference of Stable Diffusion XL base 1.0, served.

The benchmark's own statement of what one SDXL txt2img request computes,
after stabilityai/stable-diffusion-xl-base-1.0 ``unet/config.json``:

* the U-Net: 320 / 640 / 1280 channels, 2 ResBlocks a level (3 on the way
  up), no attention at level 0; each attention site one Transformer2D
  stack (group norm, ``proj_in``, ``depth`` basic blocks of self-attention,
  cross-attention over the 2048-wide context and a GEGLU feed-forward,
  ``proj_out``, one residual) of depth ``tf_depths[level]`` (1 / 2 / 10; the
  mid block takes the last level's); heads ``head_dim`` (64) wide, so
  C / 64 of them at each level;
* the "text_time" conditioning: the pooled prompt vector and the time ids
  (original size, crop top-left, target size), each id through a
  ``time_id_dim``-wide sinusoid, concatenated and put through a two-layer
  MLP (``add_embedding``) added to the time embedding;
* phase-aware sampling's partial passes, classifier-free guidance over
  [cond; uncond], whose unconditional half is a zero context, a zero pooled
  vector and the same time ids (the base pipeline's
  ``force_zeros_for_empty_prompt``), the PNDM (PLMS) update on the
  scaled-linear schedule, and the small convolutional VAE decoder the
  served model uses.

Where it departs from the published model it follows the served program,
and says so here: the feed-forward's GELU is the sigmoid form x *
sigmoid(1.702 x); the attention out-projections and the feed-forward have
no bias (11 C parameters a basic block, 915,200 over the 70); ``proj_in``
and ``proj_out`` are 1 x 1 convolutions, the same products as the
published linear projections; every group norm's eps is 1e-5 (the
published stacks' is 1e-6); the time ids' sinusoid is the time
embedding's own (cos half first, as ``flip_sin_to_cos``).

Convolutions are ``F.conv2d``, norms ``F.group_norm`` / ``F.layer_norm``,
attention is softmax over plain matrix products.  Everything is float32.
:func:`precision` sets the precision of the products: ``"fp32"`` turns
TF32 off (the reference), ``"tf32"`` turns it on (the control); on a CPU,
which has no TF32, ``"tf32"`` rounds each product's operands to TF32.

It is the model module ``sdxl``, with the contract the docstring of
``bench/reference/sd.py`` states; ``cfg`` is the configuration file's
``unet`` block, which here also gives ``tf_depths``, ``head_dim``,
``pooled_dim``, ``n_time_ids`` and ``time_id_dim``.  A request's
conditioning is ``ctx`` [ctx_len, ctx_dim], ``pooled`` [pooled_dim] and
``time_ids`` [n_time_ids].  It imports torch, contextlib, math and typing
only: nothing of the program and no other module of the benchmark.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]
FULL, SKETCH, REFINE = 0, 1, 2

_MODE = {"emulate_tf32": False}


@contextlib.contextmanager
def precision(mode: str, device: torch.device):
    """Products in float32 (``"fp32"``, TF32 off) or in TF32 (``"tf32"``)."""
    if mode not in ("fp32", "tf32"):
        raise ValueError(f"precision must be fp32 or tf32, got {mode!r}")
    tf32 = mode == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             _MODE["emulate_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _MODE["emulate_tf32"] = tf32 and torch.device(device).type != "cuda"
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         _MODE["emulate_tf32"]) = saved


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits, to nearest) where the CPU
    stands in for TF32 hardware; the identity otherwise."""
    if not _MODE["emulate_tf32"] or t.device.type == "meta":
        return t
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def conv(p: Params, x: torch.Tensor, hw: tuple[int, int], ksize: int, stride: int = 1):
    """K x K zero-padded convolution of x [B, H*W, Cin] -> [B, H'*W', Cout]."""
    bsz, _, cin = x.shape
    h, w = hw
    x4 = x.transpose(1, 2).reshape(bsz, cin, h, w)
    wt = p["w"].reshape(ksize, ksize, cin, -1).permute(3, 2, 0, 1)
    y = F.conv2d(tf32(x4), tf32(wt), p["b"], stride=stride, padding=(ksize - 1) // 2)
    return y.flatten(2).transpose(1, 2)


def group_norm(x: torch.Tensor, p: Params, groups: int, silu: bool = False, eps: float = 1e-5):
    bsz, l, c = x.shape
    y = F.group_norm(x.transpose(1, 2), groups, p["scale"], p["bias"], eps).transpose(1, 2)
    return F.silu(y) if silu else y


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def attention(q, k, v, o_proj, n_heads: int) -> torch.Tensor:
    """Multi-head softmax attention over projected [B, L, C] tensors, then
    the output projection."""
    bsz, lq, c = q.shape
    dh = c // n_heads
    heads = lambda t: t.reshape(bsz, t.shape[1], n_heads, dh).transpose(1, 2)  # noqa: E731
    logits = mm(heads(q) * dh**-0.5, heads(k).transpose(-1, -2))
    out = mm(torch.softmax(logits, dim=-1), heads(v))
    return mm(out.transpose(1, 2).reshape(bsz, lq, c), o_proj)


def upsample2x(x: torch.Tensor, hw: tuple[int, int]):
    bsz, _, c = x.shape
    h, w = hw
    x4 = F.interpolate(x.transpose(1, 2).reshape(bsz, c, h, w), scale_factor=2, mode="nearest")
    return x4.flatten(2).transpose(1, 2), (2 * h, 2 * w)


def res_block(p: Params, x, temb, hw, groups: int):
    h = conv(p["conv1"], group_norm(x, p["gn1"], groups, silu=True), hw, 3)
    h = h + (mm(F.silu(temb), p["t_proj"]["w"]) + p["t_proj"]["b"])[:, None, :]
    h = conv(p["conv2"], group_norm(h, p["gn2"], groups, silu=True), hw, 3)
    if "skip" in p:
        x = conv(p["skip"], x, hw, 1)
    return x + h


def basic_block(p: Params, h, ctx, n_heads: int):
    z = layer_norm(h, p["ln1"])
    h = h + attention(mm(z, p["self_q"]), mm(z, p["self_k"]), mm(z, p["self_v"]),
                      p["self_o"], n_heads)
    z = layer_norm(h, p["ln2"])
    h = h + attention(mm(z, p["cross_q"]), mm(ctx, p["cross_k"]), mm(ctx, p["cross_v"]),
                      p["cross_o"], n_heads)
    z = layer_norm(h, p["ln3"])
    gate, val = mm(z, p["ff_in"]).chunk(2, dim=-1)
    return h + mm(gate * torch.sigmoid(1.702 * gate) * val, p["ff_out"])


def transformer_stack(blocks: list, x, ctx, hw, n_heads: int, groups: int):
    """One Transformer2D site: the first block holds the group norm and
    ``proj_in``, the last ``proj_out``."""
    h = conv(blocks[0]["proj_in"], group_norm(x, blocks[0]["gn"], groups), hw, 1)
    for p in blocks:
        h = basic_block(p, h, ctx, n_heads)
    return conv(blocks[-1]["proj_out"], h, hw, 1) + x


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


# ---------------------------------------------------------------------------
# the U-Net
# ---------------------------------------------------------------------------


def n_up_steps(cfg: dict) -> int:
    return len(cfg["channel_mult"]) * (cfg["n_res_blocks"] + 1)


def down_blocks(cfg: dict) -> list[tuple[int, bool, bool]]:
    """(level, has attention, is the stride-2 downsample) per down entry."""
    out = []
    n_levels = len(cfg["channel_mult"])
    for lvl in range(n_levels):
        out += [(lvl, lvl in cfg["attn_levels"], False)] * cfg["n_res_blocks"]
        if lvl != n_levels - 1:
            out.append((lvl, False, True))
    return out


def up_blocks(cfg: dict) -> list[tuple[int, bool, bool]]:
    """(level, has attention, upsample after) per up-step."""
    out = []
    for lvl in reversed(range(len(cfg["channel_mult"]))):
        for i in range(cfg["n_res_blocks"] + 1):
            out.append((lvl, lvl in cfg["attn_levels"], i == cfg["n_res_blocks"] and lvl != 0))
    return out


def feature_shape(cfg: dict, entry: int, batch: int) -> tuple[int, int, int]:
    """Shape of the main-branch feature that enters up-step ``entry``."""
    ups = up_blocks(cfg)
    lvl = ups[entry][0]
    size = cfg["latent_size"] >> lvl
    chans = [cfg["base_channels"] * m for m in cfg["channel_mult"]]
    c = chans[-1] if entry == 0 else chans[ups[entry - 1][0]]
    return (batch, size * size, c)


def time_embedding(cfg: dict, p: Params, t, cond: dict) -> torch.Tensor:
    """The time MLP over the sinusoidal embedding of t [B], plus the
    text_time MLP over [pooled; sinusoid of each time id]: [B, time_dim]."""
    tm, am = p["time_mlp"], p["add_embedding"]
    temb = timestep_embedding(t, cfg["base_channels"])
    temb = mm(F.silu(mm(temb, tm["w1"]) + tm["b1"]), tm["w2"]) + tm["b2"]
    ids = cond["time_ids"]
    tid = timestep_embedding(ids.reshape(-1), cfg["time_id_dim"]).reshape(ids.shape[0], -1)
    z = torch.cat([cond["pooled"], tid], dim=-1)
    return temb + mm(F.silu(mm(z, am["w1"]) + am["b1"]), am["w2"]) + am["b2"]


def unet(cfg: dict, p: Params, x, t, cond: dict, *, entry: int = 0, feat=None, capture=()):
    """eps for x [B, L, C_in] at timesteps t [B] under ``cond`` (``ctx`` [B,
    ctx_len, ctx_dim], ``pooled`` [B, pooled_dim], ``time_ids`` [B,
    n_time_ids]); ``entry > 0`` enters up-step ``entry`` with ``feat``.
    Returns (eps, {up-step: its main-branch input}) for the steps in
    ``capture``."""
    size, groups = cfg["latent_size"], cfg["groups"]
    hw = (size, size)
    ctx = cond["ctx"]
    temb = time_embedding(cfg, p, t, cond)
    stack = lambda blocks, h, hw: transformer_stack(  # noqa: E731
        blocks, h, ctx, hw, h.shape[-1] // cfg["head_dim"], groups)

    ups = up_blocks(cfg)
    skips_needed = len(ups) - entry
    h = conv(p["conv_in"], x, hw, 3)
    skips, sizes = [h], [hw]
    for blk, (_, attn, is_down) in zip(p["down"], down_blocks(cfg)):
        if entry > 0 and len(skips) >= skips_needed:
            break
        if is_down:
            h = conv(blk["downsample"], h, hw, 3, stride=2)
            hw = (hw[0] // 2, hw[1] // 2)
        else:
            h = res_block(blk["res"], h, temb, hw, groups)
            if attn:
                h = stack(blk["tf"], h, hw)
        skips.append(h)
        sizes.append(hw)

    if entry == 0:
        m = p["mid"]
        h = res_block(m["res1"], h, temb, hw, groups)
        h = stack(m["tf"], h, hw)
        h = res_block(m["res2"], h, temb, hw, groups)
    else:
        h, hw = feat, sizes[skips_needed - 1]

    captured = {}
    for step in range(entry, len(ups)):
        if step in capture:
            captured[step] = h
        blk = p["up"][step]
        h = torch.cat([h, skips.pop()], dim=-1)
        hw = sizes.pop()
        h = res_block(blk["res"], h, temb, hw, groups)
        _, attn, up_after = ups[step]
        if attn:
            h = stack(blk["tf"], h, hw)
        if up_after:
            h, hw = upsample2x(h, hw)
            h = conv(blk["upsample"], h, hw, 3)
    h = group_norm(h, p["gn_out"], groups, silu=True)
    return conv(p["conv_out"], h, hw, 3), captured


def vae_decode(p: Params, z: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Latent [B, h*w, 4] -> image [B, 16*h*w, 3] (two 2x upsamples)."""
    h = conv(p["dec_in"], z, hw, 1)
    h = F.silu(conv(p["dec"][0], h, hw, 3))
    h, hw = upsample2x(h, hw)
    h = F.silu(conv(p["dec"][1], h, hw, 3))
    h, hw = upsample2x(h, hw)
    h = F.silu(conv(p["dec"][2], h, hw, 3))
    return conv(p["dec_out"], group_norm(h, p["dec_gn"], 8), hw, 3)


# ---------------------------------------------------------------------------
# the weight trees and one request's conditioning
# ---------------------------------------------------------------------------


def _res_layout(s, cin: int, cout: int, tdim: int) -> Params:
    d: Params = {"gn1": s.norm(cin), "conv1": s.conv(3, cin, cout), "t_proj": {}}
    s.dense(d["t_proj"], "w", tdim, cout)
    s.bias(d["t_proj"], "b", cout)
    d["gn2"] = s.norm(cout)
    d["conv2"] = s.conv(3, cout, cout)
    if cin != cout:
        d["skip"] = s.conv(1, cin, cout)
    return d


def _tf_layout(s, c: int, ctx_dim: int, first: bool, last: bool) -> Params:
    d: Params = {"gn": s.norm(c), "proj_in": s.conv(1, c, c)} if first else {}
    d["ln1"] = s.norm(c)
    for k in ("self_q", "self_k", "self_v", "self_o"):
        s.dense(d, k, c, c)
    d["ln2"] = s.norm(c)
    s.dense(d, "cross_q", c, c)
    s.dense(d, "cross_k", ctx_dim, c)
    s.dense(d, "cross_v", ctx_dim, c)
    s.dense(d, "cross_o", c, c)
    d["ln3"] = s.norm(c)
    s.dense(d, "ff_in", c, 8 * c)  # GEGLU: gate and value, 4c each
    s.dense(d, "ff_out", 4 * c, c)
    if last:
        d["proj_out"] = s.conv(1, c, c)
    return d


def unet_layout(s, cfg: dict) -> Params:
    """The served U-Net's tree: a site's stack is a list of blocks."""
    base, tdim = cfg["base_channels"], cfg["time_dim"]
    chans = [base * m for m in cfg["channel_mult"]]
    n_levels, n_res = len(chans), cfg["n_res_blocks"]
    p: Params = {"time_mlp": {}, "add_embedding": {}, "down": [], "up": []}
    s.dense(p["time_mlp"], "w1", base, tdim)
    s.bias(p["time_mlp"], "b1", tdim)
    s.dense(p["time_mlp"], "w2", tdim, tdim)
    s.bias(p["time_mlp"], "b2", tdim)
    add_in = cfg["pooled_dim"] + cfg["n_time_ids"] * cfg["time_id_dim"]
    s.dense(p["add_embedding"], "w1", add_in, tdim)
    s.bias(p["add_embedding"], "b1", tdim)
    s.dense(p["add_embedding"], "w2", tdim, tdim)
    s.bias(p["add_embedding"], "b2", tdim)
    p["conv_in"] = s.conv(3, cfg["in_channels"], base)

    def stack(c: int, depth: int) -> list:
        return [_tf_layout(s, c, cfg["ctx_dim"], i == 0, i == depth - 1) for i in range(depth)]

    depths = cfg["tf_depths"]
    ch = base
    for lvl, cout in enumerate(chans):
        for _ in range(n_res):
            blk = {"res": _res_layout(s, ch, cout, tdim)}
            if lvl in cfg["attn_levels"]:
                blk["tf"] = stack(cout, depths[lvl])
            p["down"].append(blk)
            ch = cout
        if lvl != n_levels - 1:
            p["down"].append({"downsample": s.conv(3, ch, ch)})
    p["mid"] = {"res1": _res_layout(s, ch, ch, tdim), "tf": stack(ch, depths[-1]),
                "res2": _res_layout(s, ch, ch, tdim)}
    skip_ch = [base]
    for lvl, cout in enumerate(chans):
        skip_ch += [cout] * n_res + ([cout] if lvl != n_levels - 1 else [])
    for lvl in reversed(range(n_levels)):
        cout = chans[lvl]
        for i in range(n_res + 1):
            blk = {"res": _res_layout(s, ch + skip_ch.pop(), cout, tdim)}
            if lvl in cfg["attn_levels"]:
                blk["tf"] = stack(cout, depths[lvl])
            if i == n_res and lvl != 0:
                blk["upsample"] = s.conv(3, cout, cout)
            p["up"].append(blk)
            ch = cout
    p["gn_out"] = s.norm(base)
    p["conv_out"] = s.conv(3, base, cfg["out_channels"])
    return p


def vae_layout(s, cfg: dict) -> Params:
    """The served VAE's tree (encoder and decoder) over ``cfg``'s latent
    channels."""
    latent_channels, img_channels, base = cfg["in_channels"], 3, 32
    p: Params = {"enc": [s.conv(3, cin, cout) for cin, cout in (
        (img_channels, base), (base, 2 * base), (2 * base, 2 * base), (2 * base, 2 * base))]}
    p["enc_gn"] = s.norm(2 * base)
    p["enc_out"] = s.conv(1, 2 * base, 2 * latent_channels)
    p["dec_in"] = s.conv(1, latent_channels, 2 * base)
    p["dec"] = [s.conv(3, cin, cout) for cin, cout in (
        (2 * base, 2 * base), (2 * base, 2 * base), (2 * base, base))]
    p["dec_gn"] = s.norm(base)
    p["dec_out"] = s.conv(3, base, img_channels)
    return p


def time_ids(cfg: dict) -> list[float]:
    """An uncropped image of the U-Net's own size, 8 pixels a latent cell:
    original height and width, crop top and left, target height and width
    (1024, 1024, 0, 0, 1024, 1024 at a 128 x 128 latent)."""
    side = 8.0 * cfg["latent_size"]
    return [side, side, 0.0, 0.0, side, side]


def conditioning(cfg: dict, rng) -> dict:
    """One request's conditioning from the numpy generator ``rng``: the
    prompt embedding ``ctx`` [ctx_len, ctx_dim], normal with scale 0.2, then
    the pooled prompt vector ``pooled`` [pooled_dim], normal with scale 1;
    ``time_ids`` [n_time_ids] are fixed (:func:`time_ids`)."""
    ctx = rng.normal(size=(cfg["ctx_len"], cfg["ctx_dim"])) * 0.2
    pooled = rng.normal(size=(cfg["pooled_dim"],))
    ids = torch.tensor(time_ids(cfg), dtype=torch.float32).numpy()
    return {"ctx": ctx.astype("float32"), "pooled": pooled.astype("float32"), "time_ids": ids}


def conditioning_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    return {"ctx": (cfg["ctx_len"], cfg["ctx_dim"]), "pooled": (cfg["pooled_dim"],),
            "time_ids": (cfg["n_time_ids"],)}


def with_unconditional(cond: dict) -> dict:
    """The CFG batch: each array's conditioned rows, then as many
    unconditional ones: a zero context and pooled vector, the same time
    ids."""
    return {k: torch.cat([v, v if k == "time_ids" else torch.zeros_like(v)], dim=0)
            for k, v in cond.items()}


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def alphas_cumprod(sampler: dict, device) -> torch.Tensor:
    """The scaled-linear schedule's cumulative alphas, float32."""
    t = sampler["timesteps_train"]
    betas = torch.linspace(sampler["beta_start"] ** 0.5, sampler["beta_end"] ** 0.5, t,
                           dtype=torch.float32, device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def timesteps(sampler: dict, steps: int) -> list[int]:
    stride = sampler["timesteps_train"] // steps
    return [i * stride for i in reversed(range(steps))]


def pas_branches(plan: dict | None, steps: int) -> list[int]:
    """The class of each step of a phase-aware plan (``None``: all FULL).

    Steps before ``t_complete`` are FULL; up to ``t_sketch`` every
    ``t_sparse``-th step is FULL and the rest SKETCH; the rest REFINE."""
    if plan is None:
        return [FULL] * steps
    out = []
    for t in range(steps):
        if t < plan["t_complete"]:
            out.append(FULL)
        elif t < plan["t_sketch"]:
            since = t - plan["t_complete"]
            out.append(FULL if (since + 1) % plan["t_sparse"] == 0 else SKETCH)
        else:
            out.append(REFINE)
    return out


def tier_plan(tier: str, steps: int) -> dict | None:
    """The PAS plan of a quality tier: ``exact`` is all FULL; ``draft``,
    ``balanced`` and ``high`` move the sketch transition later and the FULL
    refreshes closer together, in that order."""
    if tier == "exact":
        return None
    if tier == "draft":
        t_sketch = max(1, steps // 3)
        return dict(t_sketch=t_sketch, t_complete=min(t_sketch, max(1, steps // 12)), t_sparse=6)
    if tier == "balanced":
        t_sketch = max(1, steps // 2)
        return dict(t_sketch=t_sketch, t_complete=min(t_sketch, max(2, steps // 10)), t_sparse=4)
    if tier == "high":
        t_sketch = max(1, (3 * steps) // 4)
        return dict(t_sketch=t_sketch, t_complete=min(t_sketch, max(2, steps // 4)), t_sparse=2)
    raise ValueError(f"unknown tier {tier!r}")


def plms_eps(ring: list[torch.Tensor]) -> torch.Tensor:
    """Adams-Bashforth eps' of the order the ring's length allows (newest
    first)."""
    e = ring
    if len(e) == 1:
        return e[0]
    if len(e) == 2:
        return (3 * e[0] - e[1]) / 2
    if len(e) == 3:
        return (23 * e[0] - 16 * e[1] + 5 * e[2]) / 12
    return (55 * e[0] - 59 * e[1] + 37 * e[2] - 9 * e[3]) / 24


def sample(cfg: dict, sampler: dict, p: Params, noise, cond: dict, tier: str, *, l_sketch: int,
           l_refine: int) -> torch.Tensor:
    """Run requests of one tier straight through: noise [B, L, 4] and the
    conditioning by name (``ctx``, ``pooled``, ``time_ids``, each batched)
    -> final latents [B, L, 4]."""
    steps = sampler["steps"]
    ab = alphas_cumprod(sampler, noise.device)
    ts = timesteps(sampler, steps)
    branches = pas_branches(tier_plan(tier, steps), steps)
    n_up = n_up_steps(cfg)
    e_sk, e_rf = n_up - l_sketch, n_up - l_refine
    cond2 = with_unconditional(cond)
    g = sampler["guidance_scale"]
    x, ring, feats = noise, [], {}
    for i, (t, br) in enumerate(zip(ts, branches)):
        t_prev = ts[i + 1] if i + 1 < steps else -1
        x2 = torch.cat([x, x], dim=0)
        tt = torch.full((x2.shape[0],), t, device=x.device, dtype=torch.int64)
        if br == FULL:
            eps2, feats = unet(cfg, p, x2, tt, cond2, capture=(e_sk, e_rf))
        else:
            entry = e_sk if br == SKETCH else e_rf
            eps2, _ = unet(cfg, p, x2, tt, cond2, entry=entry, feat=feats[entry])
        e_c, e_u = eps2.chunk(2, dim=0)
        ring = [e_u + g * (e_c - e_u)] + ring[:3]
        eps = plms_eps(ring)
        a_t = ab[t]
        a_p = ab[t_prev] if t_prev >= 0 else torch.ones((), device=x.device)
        x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        x = torch.sqrt(a_p) * x0 + torch.sqrt(1 - a_p) * eps
    return x
