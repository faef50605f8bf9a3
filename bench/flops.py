"""Operations and bytes: per backend call from its shapes, per micro-step
class from the reference, and the peaks they are held against.

A roofline share is the least time the work could take on the chip,
max(operations / peak rate, bytes / peak bandwidth), over the device time
the work took.  Operations count each product once (two per
multiply-add); bytes count each float32 input read once and each output
written once, whatever an implementation reads again.
"""
from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode

#: one NVIDIA H100 SXM (data sheet, dense, at the 700 W limit):
#: TF32 tensor-core rate, the ceiling of any product on float32 operands,
#: and HBM3 bandwidth
PEAK_FLOPS = 495e12
PEAK_BYTES_S = 3.35e12
F32 = 4


def conv_cost(x_shape, w_shape, hw, ksize: int, stride: int) -> tuple[int, int]:
    """(operations, bytes) of a K x K conv: x [B, H*W, Cin], w [K*K, Cin,
    Cout], bias [Cout], output [B, H'*W', Cout] with H' = ceil(H / stride)."""
    b, _, cin = x_shape
    cout = w_shape[2]
    h_out, w_out = -(-hw[0] // stride), -(-hw[1] // stride)
    out = b * h_out * w_out * cout
    ops = 2 * out * cin * ksize * ksize
    nbytes = F32 * (b * hw[0] * hw[1] * cin + ksize * ksize * cin * cout + cout + out)
    return ops, nbytes


def attention_cost(q_shape, k_shape, n_heads: int) -> tuple[int, int]:
    """(operations, bytes) of multi-head softmax attention over projected q
    [B, Lq, C] and k, v [B, Lk, C], then the [C, C] output projection."""
    b, lq, c = q_shape
    lk = k_shape[1]
    ops = 2 * 2 * b * lq * lk * c + 2 * b * lq * c * c
    nbytes = F32 * (2 * b * lq * c + 2 * b * lk * c + c * c)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def class_flops(cfg: dict, l_sketch: int, l_refine: int, model=None) -> dict[str, int]:
    """Operations of one CFG pair (batch 2) of each micro-step class, and of
    one VAE decode, counted by ``FlopCounterMode`` over the model module's
    reference (``sd`` where ``model`` is None) on meta tensors, its
    conditioning shaped by ``conditioning_shapes``."""
    import torch

    from bench.reference.weights import _Spec

    if model is None:
        from bench import spec

        model = spec.load_model(spec.DEFAULT_MODEL)

    def meta_tree(layout):
        s = _Spec()
        tree = layout(s, cfg)
        for holder, key, shape, _, _ in s.leaves:
            holder[key] = torch.empty(shape, device="meta")
        return tree

    p = meta_tree(model.unet_layout)
    vae = meta_tree(model.vae_layout)
    L = cfg["latent_size"] ** 2
    x = torch.empty((2, L, cfg["in_channels"]), device="meta")
    t = torch.zeros((2,), dtype=torch.int64, device="meta")
    cond = {k: torch.empty((2, *shape), device="meta")
            for k, shape in model.conditioning_shapes(cfg).items()}
    n_up = model.n_up_steps(cfg)
    out = {}
    for name, entry in (("FULL", 0), ("SKETCH", n_up - l_sketch), ("REFINE", n_up - l_refine)):
        feat = torch.empty(model.feature_shape(cfg, entry, 2), device="meta") if entry else None
        with FlopCounterMode(display=False) as fc:
            model.unet(cfg, p, x, t, cond, entry=entry, feat=feat)
        out[name] = fc.get_total_flops()
    z = torch.empty((1, L, cfg["in_channels"]), device="meta")
    with FlopCounterMode(display=False) as fc:
        model.vae_decode(vae, z, (cfg["latent_size"],) * 2)
    out["DECODE"] = fc.get_total_flops()
    return out
