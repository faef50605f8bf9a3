"""The port's LM layers against the JAX package's, on the CPU.

Norms (rmsnorm, the one-pass layernorm), the activations (SiLU and the
sigmoid GELU), the MLP, MoE (capacity, routing order on constructed ties,
dropped pairs through the overflow row), RoPE, ``attend`` in its one-shot
and query-chunked branches (values and gradients), and ``decode_attend``
on a ring that wraps and on a linear cache.  Inputs are drawn with numpy
from fixed seeds and fed to both packages; float32 results agree within
1e-6 of the largest value (measured: at most 3.5e-7), bf16 ones within one
bf16 step of each value or 2 steps of the largest (measured: bitwise
equal).

Two bf16 traps are shown where they bite: JAX rounds a Python float to
bf16 before it multiplies a bf16 array, torch does not, so GELU's 1.702
and attention's head_dim**-0.5 (head_dim 8 here, not a power of 4) are
rounded to the tensor's dtype first; the unrounded torch product differs
from JAX's on many elements.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import GLOBAL as JGLOBAL
from repro.common.types import LMConfig as JLMConfig
from repro.common.types import MoESpec as JMoESpec
from repro.common.types import local as jlocal
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.common.types import GLOBAL, LMConfig, MoESpec, local
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

F32_TOL = 1e-6  # of the largest |value|
BF16_STEP = 2.0**-7  # one bf16 step at most, relative (7 stored mantissa bits)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand(seed, shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


def _pair(arr, dtype="float32"):
    """(jax array, torch tensor) of the same values in ``dtype``."""
    j = jnp.asarray(arr).astype(dtype)
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(TL.torch_dtype(dtype))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _bf16_steps(a, b):
    """Largest |a - b| in bf16 steps of |b|."""
    a, b = _np(a), _np(b)
    return float((np.abs(a - b) / np.maximum(np.abs(b) * BF16_STEP, 1e-30)).max())


def _cfgs(**kw):
    """The same LMConfig in both packages."""
    base = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=48, vocab_size=64, dtype="float32")
    base.update(kw)
    jkw = dict(base)
    if "moe" in base:
        jkw["moe"] = JMoESpec(**dataclasses.asdict(base["moe"]))
    return JLMConfig(**jkw), LMConfig(**base)


# ---------------------------------------------------------------------------
# norms, activations, MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm_matches(norm, dtype):
    jc, tc = _cfgs(norm=norm)
    x = _rand(0, (2, 5, 32), scale=2.0, shift=3.0)  # a large mean: the one-pass variance
    scale, bias = _rand(1, (32,), shift=1.0), _rand(2, (32,))
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    if norm == "rmsnorm":
        del jp["bias"], tp["bias"]
    jx, tx = _pair(x, dtype)
    got, want = TL.apply_norm(tc, tp, tx), JL.apply_norm(jc, jp, jx)
    assert got.dtype == TL.torch_dtype(dtype)
    if dtype == "float32":
        assert _rel(got, want) <= F32_TOL
    else:
        assert _bf16_steps(got, want) <= 1.0


def test_init_norm_is_float32_with_a_bias_for_layernorm():
    for norm in ("rmsnorm", "layernorm"):
        jc, tc = _cfgs(norm=norm, dtype="bfloat16")
        jp, tp = JL.init_norm(jc, 8), TL.init_norm(tc, 8, "cpu")
        assert sorted(tp) == sorted(jp)
        assert all(t.dtype == torch.float32 for t in tp.values())
        for k in jp:
            np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_act_fn_matches(name, dtype):
    x = _rand(3, (4096,), scale=3.0)
    jx, tx = _pair(x, dtype)
    got, want = TL.act_fn(name)(tx), JL.act_fn(name)(jx)
    if dtype == "float32":
        assert _rel(got, want) <= F32_TOL
    else:
        assert _bf16_steps(got, want) <= 1.0


def test_gelu_rounds_its_constant_as_jax_does():
    """JAX multiplies a bf16 array by 1.702 rounded to bf16 (1.703125);
    torch's ``1.702 * x`` would not round it."""
    jx, tx = _pair(_rand(4, (4096,), scale=3.0), "bfloat16")
    want = _np(JL.act_fn("gelu")(jx))
    got = _np(TL.act_fn("gelu")(tx))
    naive = _np(tx * TL._sigmoid(1.702 * tx))
    np.testing.assert_array_equal(got, want)
    assert np.sum(naive != want) > 100, np.sum(naive != want)


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_sigmoid_is_jax_formula_in_bf16(name):
    """``jax.nn.sigmoid`` is 1 / (1 + exp(-x)) with every op rounded to
    bf16; ``torch.sigmoid`` rounds once and differs on about a quarter of
    the elements.  The port's activations equal JAX's bitwise."""
    jx, tx = _pair(_rand(9, (4096,), scale=3.0), "bfloat16")
    np.testing.assert_array_equal(_np(TL.act_fn(name)(tx)), _np(JL.act_fn(name)(jx)))
    assert np.sum(_np(torch.sigmoid(tx)) != _np(jax.nn.sigmoid(jx))) > 100


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True), ("gelu", False)])
def test_apply_mlp_matches(act, glu):
    jc, tc = _cfgs(act=act, glu=glu)
    w = {"w_in": _rand(5, (32, 48), 0.2), "w_out": _rand(6, (48, 32), 0.2),
         "w_gate": _rand(7, (32, 48), 0.2)}
    if not glu:
        del w["w_gate"]
    x = _rand(8, (2, 5, 32))
    got = TL.apply_mlp(tc, {k: torch.from_numpy(v) for k, v in w.items()}, torch.from_numpy(x))
    want = JL.apply_mlp(jc, {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    assert _rel(got, want) <= F32_TOL


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe(e=4, k=2, d=32, f=24, seed=10, router=None):
    jc, tc = _cfgs(d_model=d, d_ff=0, family="moe", act="silu",
                   moe=MoESpec(num_experts=e, top_k=k, d_expert=f))
    w = {"router": _rand(seed, (d, e), 0.5) if router is None else router,
         "w_in": _rand(seed + 1, (e, d, f), 0.2), "w_gate": _rand(seed + 2, (e, d, f), 0.2),
         "w_out": _rand(seed + 3, (e, f, d), 0.2)}
    return (jc, {k_: jnp.asarray(v) for k_, v in w.items()},
            tc, {k_: torch.from_numpy(v) for k_, v in w.items()})


@pytest.mark.parametrize("n", [1, 5, 16, 64, 1000])
@pytest.mark.parametrize("spec", [(4, 2, 1.25), (8, 4, 1.25), (128, 8, 1.0), (8, 2, 8.0)])
def test_moe_capacity_equal(spec, n):
    e, k, cf = spec
    js = JMoESpec(num_experts=e, top_k=k, d_expert=8, capacity_factor=cf)
    ts = MoESpec(num_experts=e, top_k=k, d_expert=8, capacity_factor=cf)
    assert TL.moe_capacity(ts, n) == JL.moe_capacity(js, n)


def test_top_k_order_on_ties_is_lax_top_k():
    """Equal router probabilities: ``jax.lax.top_k`` puts the lower index
    first, and so does the port's stable sort."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.2, 0.4, 0.0],
                      [0.0, 0.5, 0.0, 0.5],
                      [0.2, 0.2, 0.3, 0.3]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = TL.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cap", [16, 6, 2])
def test_moe_one_group_matches_with_drops(cap):
    """cap 16 keeps every pair of 16 tokens x top-2; 6 and 2 drop pairs
    through the overflow row."""
    jc, jp, tc, tp = _moe()
    x = _rand(20, (16, 32))
    jo, jaux = jax.jit(lambda p, x: JL._moe_one_group(jc, p, x, cap))(jp, jnp.asarray(x))
    to, taux = TL._moe_one_group(tc, tp, torch.from_numpy(x), cap)
    assert _rel(to, jo) <= F32_TOL
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    if cap == 2:  # 32 pairs over 4 experts x 2 slots: most pairs dropped
        assert float((to == 0).all(dim=-1).sum()) > 0


def test_moe_all_ties_route_to_the_lowest_experts_and_drop():
    """A zero router gives every expert the same probability: top-2 picks
    experts 0 and 1 for every token, which fill their 4 slots with the
    first 4 tokens; every later pair is dropped to the overflow row."""
    jc, jp, tc, tp = _moe(router=np.zeros((32, 4), np.float32))
    x = _rand(21, (16, 32))
    jo, jaux = JL._moe_one_group(jc, jp, jnp.asarray(x), 4)
    to, taux = TL._moe_one_group(tc, tp, torch.from_numpy(x), 4)
    assert _rel(to, jo) <= F32_TOL
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    assert bool((to[4:] == 0).all()) and bool((to[:4] != 0).any(dim=-1).all())


def test_apply_moe_matches_with_a_biased_router():
    """Two rows of 64 tokens, a router that sends most tokens to expert 0:
    capacity min(moe_capacity(64), 64) = 40 drops pairs."""
    router = _rand(22, (32, 4), 0.3)
    router[:, 0] += 1.0
    jc, jp, tc, tp = _moe(router=router)
    x = _rand(23, (2, 64, 32), shift=0.5)
    jo, jaux = jax.jit(lambda p, x: JL.apply_moe(jc, p, x))(jp, jnp.asarray(x))
    to, taux = TL.apply_moe(tc, tp, torch.from_numpy(x))
    assert _rel(to, jo) <= F32_TOL
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    assert TL.moe_capacity(tc.moe, 64) == 40


def test_moe_gradients_match():
    jc, jp, tc, tp = _moe()
    x = _rand(24, (2, 16, 32))

    def jloss(p, x):
        out, aux = JL.apply_moe(jc, p, x)
        return jnp.sum(out * out) + aux

    jg = jax.jit(jax.grad(jloss))(jp, jnp.asarray(x))
    live = {k: v.clone().requires_grad_() for k, v in tp.items()}
    out, aux = TL.apply_moe(tc, live, torch.from_numpy(x))
    (torch.sum(out * out) + aux).backward()
    for k in jp:
        assert _rel(live[k].grad, jg[k]) <= 1e-5, k


# ---------------------------------------------------------------------------
# RoPE and full-sequence attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches(dtype):
    x = _rand(30, (2, 24, 4, 16))
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32) * 37  # large angles
    jx, tx = _pair(x, dtype)
    got = TA.apply_rope(tx, torch.from_numpy(pos.copy()), 1_000_000.0)
    want = JA.apply_rope(jx, jnp.asarray(pos), 1_000_000.0)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        assert _rel(got, want) <= 2e-6
    else:
        assert _bf16_steps(got, want) <= 1.0


def _qkv(seed, b, s, h, hkv, dh, dtype="float32"):
    return [_pair(_rand(seed + i, (b, s, n, dh)), dtype) for i, n in enumerate((h, hkv, hkv))]


ATTEND_CASES = {
    "global": (GLOBAL, JGLOBAL, 0.0),
    "local": (local(5), jlocal(5), 0.0),
    "softcap": (GLOBAL, JGLOBAL, 3.0),
    "local_softcap": (local(7), jlocal(7), 50.0),
}


@pytest.mark.parametrize("q_chunk", [0, 8])
@pytest.mark.parametrize("case", list(ATTEND_CASES))
def test_attend_matches(case, q_chunk):
    """q_chunk 0 picks 32 at S=32 (one shot); 8 takes the chunked branch."""
    spec, jspec, cap = ATTEND_CASES[case]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(31, 2, 32, 4, 2, 16)
    got = TA.attend(tq, tk, tv, spec, attn_softcap=cap, q_chunk=q_chunk)
    want = JA.attend(jq, jk, jv, jspec, attn_softcap=cap, q_chunk=q_chunk)
    assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("s", [16, 32, 100, 1024, 4096, 6144, 65536])
def test_adaptive_q_chunk_is_the_reference_rule(s):
    q_chunk = max(128, min(1024, 2**21 // s))
    while s % q_chunk:
        q_chunk //= 2
    assert TA.adaptive_q_chunk(s) == q_chunk
    assert TA.adaptive_q_chunk(4096) == 512  # gemma3-1b's 4k forward: 8 chunks


def test_attend_chunked_gradients_match():
    """The chunked branch recomputes each chunk in the backward
    (torch.utils.checkpoint): gradients equal JAX's checkpointed scan."""
    spec, jspec, cap = ATTEND_CASES["local_softcap"]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(32, 1, 32, 4, 1, 8)
    g = _rand(35, (1, 32, 4, 8))

    def jloss(q, k, v):
        return jnp.sum(JA.attend(q, k, v, jspec, attn_softcap=cap, q_chunk=8) * g)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jq, jk, jv)
    for q_chunk in (8, 0):
        live = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        out = TA.attend(*live, spec, attn_softcap=cap, q_chunk=q_chunk)
        torch.sum(out * torch.from_numpy(g)).backward()
        for t, jgrad in zip(live, jgrads):
            assert _rel(t.grad, jgrad) <= 1e-5


def test_attend_scale_is_rounded_to_bf16_first():
    """head_dim 8: 8**-0.5 is not a bf16 value.  JAX rounds it, then the
    product; the port's ``_scale_q`` equals JAX bitwise, torch's plain
    ``q * 8**-0.5`` does not."""
    jq, tq = _pair(_rand(36, (2, 16, 4, 8), scale=3.0), "bfloat16")
    want = _np(jq * (8**-0.5))
    np.testing.assert_array_equal(_np(TA._scale_q(tq)), want)
    assert np.sum(_np(tq * 8**-0.5) != want) > 20


def test_attend_bf16_matches():
    """bf16 q, k, v: float32 scores from the bf16 operands, bf16 weights
    and output, against JAX's preferred_element_type product."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(37, 2, 32, 4, 1, 8, "bfloat16")
    for q_chunk in (0, 8):
        got = TA.attend(tq, tk, tv, local(9), attn_softcap=20.0, q_chunk=q_chunk)
        want = JA.attend(jq, jk, jv, jlocal(9), attn_softcap=20.0, q_chunk=q_chunk)
        assert got.dtype == torch.bfloat16
        assert _rel(got, want) <= 2 * BF16_STEP


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("length", [3, 4, 11, 20])
def test_cache_positions_equal(ring, length):
    for pos in range(0, 3 * length):
        got = TA.cache_positions(length, pos, ring)
        want = JA.cache_positions(length, jnp.asarray(pos), ring)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["ring", "linear", "short_local"])
def test_decode_attend_matches_over_a_stream(case, dtype):
    """12 decode steps: a window-4 ring wraps twice; a linear cache of 12;
    a local(8) layer whose max_len 6 is shorter than its window (a linear
    buffer).  Outputs at every step and the final cache contents equal."""
    spec, jspec, max_len, cap = {
        "ring": (local(4), jlocal(4), 12, 0.0),
        "linear": (GLOBAL, JGLOBAL, 12, 30.0),
        "short_local": (local(8), jlocal(8), 6, 0.0),
    }[case]
    steps = min(12, max_len)
    tc = TA.init_kv_cache(2, max_len, 2, 8, spec, TL.torch_dtype(dtype), "cpu")
    jc = JA.init_kv_cache(2, max_len, 2, 8, jspec, jnp.dtype(dtype))
    assert tc.length == jc.length
    for pos in range(steps):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(40 + 3 * pos, 2, 1, 4, 2, 8, dtype)
        got, tc = TA.decode_attend(tq, tk, tv, tc, pos, spec, attn_softcap=cap)
        want, jc = JA.decode_attend(jq, jk, jv, jc, jnp.asarray(pos), jspec, attn_softcap=cap)
        if dtype == "float32":
            assert _rel(got, want) <= F32_TOL, pos
        else:
            assert _rel(got, want) <= 2 * BF16_STEP, pos
    np.testing.assert_array_equal(_np(tc.k), _np(jc.k))
    np.testing.assert_array_equal(_np(tc.v), _np(jc.v))
