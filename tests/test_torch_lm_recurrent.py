"""The port's recurrent LM families (xlstm, hymba) against the JAX package's.

For xlstm-350m and hymba-1.5b at their SMOKE size, the JAX reference runs
once per module (``_reference``: a jitted init from ``jax.random.key(0)``,
a jitted forward, one jitted ``make_train_step`` step), without a mesh, at
``FAST_COMPILE``, and its weights are bridged to the port
(``bridge.lm_params_from_numpy``).  Inputs come from numpy with fixed
seeds.  Tolerances, and the largest deviation measured on the CPU:

* forward logits relative to max |logit|: 1e-4 (measured 9.0e-7 xlstm,
  4.5e-7 hymba); the aux loss, 0 in both, 1e-5;
* xlstm's chunkwise form at ``chunk_size`` 1 and 4 over S = 16 (the
  4-chunk case carries the state between chunks) against the reference at
  the same chunk size, and the adapter over S = 512 (two chunks of 256):
  1e-4 (measured 9.7e-7, 1.0e-6 and 2.8e-6);
* one train step (lr 1e-3, warmup 1): the loss 1e-5 relative (measured
  0); AdamW's m and v within 1e-4 of each leaf's largest value (8.0e-6);
  the parameters within 0.5 lr (0.078 lr) (``tests/test_torch_lm.py``'s
  tolerances);
* decode against the reference's forward, 1e-4 (measured 8.8e-7);
* hymba over 1 x 1040 tokens, past its 1024-token window: the port's
  forward and its decode at all 1040 positions (the ring wraps at 1024)
  against the reference's forward, 1e-4 (measured 6.3e-7 and 6.0e-7);
* bf16 SMOKE logits within 2e-2 of max |logit| (measured: xlstm bitwise
  equal, hymba 1.0e-2).

Besides: the parameter trees are the reference's leaf for leaf; every
layer of hymba's decode cache is its own storage; both packages refuse a
sequence that the chunk does not divide with the same message; remat
changes no number of a train step; ``serve --mode lm`` on hymba's SMOKE
gives the reference ``serve_lm``'s greedy tokens.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_lm_config as j_get_lm_config
from repro.launch import serve as JS
from repro.launch import steps as JST
from repro.models import xlstm as JX
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_adamw as j_init_adamw
from repro_torch import bridge
from repro_torch.common.tree import tree_leaves, tree_leaves_with_path
from repro_torch.configs import get_lm_config
from repro_torch.launch import serve as TS
from repro_torch.launch import steps as ST
from repro_torch.models import hymba as HY
from repro_torch.models import xlstm as X
from repro_torch.optim import AdamWConfig, init_adamw

ARCHS = ["xlstm-350m", "hymba-1.5b"]
B, S = 2, 16
OPT = dict(lr=1e-3, total_steps=10, warmup_steps=1)
#: XLA options of the reference compiles: its HLO, compiled faster
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
#: logits relative to max |logit|; aux and loss relative; m and v as a
#: fraction of each leaf's largest value; parameters in units of lr
LOGIT_TOL, LOSS_RTOL, MV_TOL, PARAM_TOL = 1e-4, 1e-5, 1e-4, 0.5
BF16_LOGIT_TOL = 2e-2
#: hymba's window test: 16 tokens past the 1024-token window
LONG = HY.HYMBA_WINDOW + 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def _j_forward(ad, params, x):
    logits, aux = _jit(ad.forward, params, x)(params, x)
    return np.asarray(logits, np.float32), float(aux)


def _reference(arch: str, dtype: str | None = None) -> dict:
    """The JAX package's results on ``arch``'s SMOKE config (optionally in
    another dtype), as numpy; the jitted params stay for further calls."""
    cfg = j_get_lm_config(arch, "smoke")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    ad = JST.get_adapter(cfg)
    key = jax.random.key(0)
    params = _jit(ad.init, key)(key)
    x = jnp.asarray(_tokens(cfg, (B, S), 1))
    logits, aux = _j_forward(ad, params, x)
    out = dict(arch=arch, cfg=cfg, ad=ad, jparams=params, params=_np_tree(params),
               logits=logits, aux=aux)
    if dtype is not None:
        return out
    batch = {"inputs": x, "labels": jnp.asarray(_tokens(cfg, (B, S), 2))}
    opt = j_init_adamw(params)
    step = JST.make_train_step(ad, JAdamWConfig(**OPT), remat=False)
    p1, o1, loss = _jit(step, params, opt, batch)(params, opt, batch)
    out.update(loss=float(loss), p1=_np_tree(p1), m1=_np_tree(o1.m), v1=_np_tree(o1.v))
    return out


@pytest.fixture(scope="module")
def refs():
    """(arch, dtype) -> the reference's results, each computed on first use."""
    return {}


def _ref(refs, arch, dtype=None):
    if (arch, dtype) not in refs:
        refs[(arch, dtype)] = _reference(arch, dtype)
    return refs[(arch, dtype)]


def _port(ref):
    cfg = dataclasses.replace(get_lm_config(ref["arch"], "smoke"), dtype=ref["cfg"].dtype)
    return cfg, ST.get_adapter(cfg), bridge.lm_params_from_numpy(ref["params"])


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _decode_all(ad, params, toks: np.ndarray) -> torch.Tensor:
    """Teacher-forced decode of every position of ``toks`` [B, S] from an
    empty cache -> logits [B, S, V]."""
    b, s = toks.shape
    t = torch.from_numpy(toks)
    cache, out = ad.init_cache(b, s, "cpu"), []
    with torch.no_grad():
        for pos in range(s):
            lg, cache = ad.decode(params, cache, t[:, pos], pos)
            out.append(lg)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_is_the_reference_tree(refs, arch, dtype):
    """Same keys, shapes and dtypes leaf for leaf (the gates, ``w_dt``,
    ``b_dt``, ``a_log``, ``d_skip`` and the norms stay float32 in a bf16
    model); hymba's ``a_log`` is the reference's log(1..N) rows, within
    float32 rounding of ``log``."""
    jcfg = dataclasses.replace(j_get_lm_config(arch, "smoke"), dtype=dtype)
    cfg = dataclasses.replace(get_lm_config(arch, "smoke"), dtype=dtype)
    jad, ad = JST.get_adapter(jcfg), ST.get_adapter(cfg)
    jshapes = jax.eval_shape(jad.init, jax.random.key(0))
    want = [(jax.tree_util.keystr(k), v.shape, str(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(jshapes)]
    params = ad.init(torch.Generator().manual_seed(0), "cpu")
    got = [(k, tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in tree_leaves_with_path(params)]
    assert got == want
    if cfg.family == "hybrid" and dtype == "float32":
        np.testing.assert_allclose(params["blocks"]["ssm"]["a_log"].numpy(),
                                   _ref(refs, arch)["params"]["blocks"]["ssm"]["a_log"],
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match(refs, arch):
    ref = _ref(refs, arch)
    cfg, ad, params = _port(ref)
    with torch.no_grad():
        logits, aux = ad.forward(params, torch.from_numpy(_tokens(cfg, (B, S), 1)))
    assert logits.shape == ref["logits"].shape
    assert _rel(logits, ref["logits"]) <= LOGIT_TOL
    assert abs(float(aux) - ref["aux"]) <= LOSS_RTOL


@pytest.mark.parametrize("chunk", [1, 4])
def test_xlstm_chunk_sizes_match_the_reference(refs, chunk):
    """The plain recurrence (chunk 1) and four chunks of 4 (the state
    carried between chunks) against the reference at the same chunk."""
    ref = _ref(refs, "xlstm-350m")
    cfg, _, params = _port(ref)
    x = _tokens(cfg, (B, S), 1)
    want, _ = _jit(lambda p, t: JX.xlstm_forward(ref["cfg"], p, t, chunk_size=chunk),
                   ref["jparams"], jnp.asarray(x))(ref["jparams"], jnp.asarray(x))
    with torch.no_grad():
        got, _ = X.xlstm_forward(cfg, params, torch.from_numpy(x), chunk_size=chunk)
    assert _rel(got, want) <= LOGIT_TOL
    assert _rel(got, ref["logits"]) <= LOGIT_TOL  # every form is the same function


def test_xlstm_adapter_over_two_chunks_matches(refs):
    """The adapter's default chunk of 256 at S = 512: two chunks."""
    ref = _ref(refs, "xlstm-350m")
    cfg, ad, params = _port(ref)
    x = _tokens(cfg, (1, 512), 4)
    want, _ = _j_forward(ref["ad"], ref["jparams"], jnp.asarray(x))
    with torch.no_grad():
        got, _ = ad.forward(params, torch.from_numpy(x))
    assert _rel(got, want) <= LOGIT_TOL


def test_xlstm_refuses_a_length_the_chunk_does_not_divide(refs):
    ref = _ref(refs, "xlstm-350m")
    cfg, _, params = _port(ref)
    x = _tokens(cfg, (1, 6), 5)
    with pytest.raises(AssertionError) as jerr:
        JX.xlstm_forward(ref["cfg"], ref["jparams"], jnp.asarray(x), chunk_size=4)
    with pytest.raises(AssertionError) as terr:
        X.xlstm_forward(cfg, params, torch.from_numpy(x), chunk_size=4)
    assert str(terr.value) == str(jerr.value) == "seq 6 % chunk 4"


def _port_step(ref, remat=False):
    cfg, ad, params = _port(ref)
    batch = {"inputs": torch.from_numpy(_tokens(cfg, (B, S), 1)),
             "labels": torch.from_numpy(_tokens(cfg, (B, S), 2))}
    step = ST.make_train_step(ad, AdamWConfig(**OPT), remat=remat)
    return step(params, init_adamw(params), batch)


@pytest.fixture(scope="module")
def port_steps(refs):
    """arch -> the port's first train step on the reference's weights."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _port_step(_ref(refs, arch))
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_matches(refs, port_steps, arch):
    _, _, loss = port_steps(arch)
    want = _ref(refs, arch)["loss"]
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_moments_match(refs, port_steps, arch):
    _, opt, _ = port_steps(arch)
    ref = _ref(refs, arch)
    for name in ("m", "v"):
        for got, want in zip(tree_leaves(getattr(opt, name)), jax.tree.leaves(ref[name + "1"])):
            assert float(np.abs(got.numpy() - want).max()) <= MV_TOL * float(
                np.abs(want).max()), name


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_params_match(refs, port_steps, arch):
    params, opt, _ = port_steps(arch)
    assert int(opt.step) == 1
    for got, want in zip(tree_leaves(params), jax.tree.leaves(_ref(refs, arch)["p1"])):
        assert float(np.abs(got.numpy() - want).max()) <= PARAM_TOL * OPT["lr"]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_step_equals_the_plain_step(refs, port_steps, arch):
    """``remat=True`` recomputes each layer in the backward: no number moves."""
    params, opt, loss = port_steps(arch)
    rp, ro, rloss = _port_step(_ref(refs, arch), remat=True)
    assert float(rloss) == float(loss)
    for a, b in zip(tree_leaves((rp, ro.m, ro.v)), tree_leaves((params, opt.m, opt.v))):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_reference_forward(refs, arch):
    """16 teacher-forced steps from an empty state: one step is the
    chunkwise cell at C = 1 (xlstm), the conv buffer and the selective
    scan's state (hymba)."""
    ref = _ref(refs, arch)
    cfg, ad, params = _port(ref)
    got = _decode_all(ad, params, _tokens(cfg, (B, S), 1))
    assert _rel(got, ref["logits"]) <= LOGIT_TOL


@pytest.fixture(scope="module")
def hymba_long(refs):
    """The reference's hymba forward over 1 x LONG tokens, and the tokens."""
    ref = _ref(refs, "hymba-1.5b")
    x = _tokens(ref["cfg"], (1, LONG), 6)
    logits, _ = _j_forward(ref["ad"], ref["jparams"], jnp.asarray(x))
    return x, logits


def test_hymba_forward_past_the_window_matches(refs, hymba_long):
    """1040 tokens: the window mask of ``local(1024)`` cuts in."""
    x, want = hymba_long
    _, ad, params = _port(_ref(refs, "hymba-1.5b"))
    with torch.no_grad():
        got, _ = ad.forward(params, torch.from_numpy(x))
    assert _rel(got, want) <= LOGIT_TOL
    assert _rel(got[:, -16:], want[:, -16:]) <= LOGIT_TOL


def test_hymba_decode_past_the_window_matches_the_forward(refs, hymba_long):
    """Decode over the same 1040 positions: the ring of 1024 slots wraps
    at position 1024; every position, the last 16 among them, equals the
    reference's forward."""
    x, want = hymba_long
    _, ad, params = _port(_ref(refs, "hymba-1.5b"))
    got = _decode_all(ad, params, x)
    assert ad.init_cache(1, LONG, "cpu").kv.k.shape[2] == HY.HYMBA_WINDOW
    assert _rel(got[:, -16:], want[:, -16:]) <= LOGIT_TOL
    assert _rel(got, want) <= LOGIT_TOL


def test_hymba_cache_layers_do_not_alias(refs):
    """``init_cache`` gives every layer its own zeros: after two decode
    steps layer 0's and layer 1's KV and SSM state differ."""
    cfg, ad, params = _port(_ref(refs, "hymba-1.5b"))
    cache = ad.init_cache(B, S, "cpu")
    leaves = tree_leaves(cache)
    assert len({t.untyped_storage().data_ptr() for t in leaves}) == len(leaves)
    assert all(t.stride(0) > 0 for t in leaves)
    toks = torch.from_numpy(_tokens(cfg, (B, 2), 7))
    with torch.no_grad():
        for pos in range(2):
            _, cache = ad.decode(params, cache, toks[:, pos], pos)
    for t in tree_leaves(cache):
        assert t[0].abs().max() > 0 and t[1].abs().max() > 0
        assert not torch.equal(t[0], t[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches(refs, arch):
    """The SMOKE config in bf16: weights, activations and logits in bf16;
    gates, the cell and the selective scan in float32; hymba's conv taps
    summed in bf16."""
    ref = _ref(refs, arch, "bfloat16")
    cfg, ad, params = _port(ref)
    assert params["embed"].dtype == torch.bfloat16
    with torch.no_grad():
        logits, _ = ad.forward(params, torch.from_numpy(_tokens(cfg, (B, S), 1)))
    assert logits.dtype == torch.bfloat16
    assert _rel(logits.float(), ref["logits"]) <= BF16_LOGIT_TOL


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def test_serve_lm_hymba_matches_the_reference(monkeypatch, capsys):
    """The reference's ``serve_lm`` on hymba-1.5b SMOKE (3 requests in
    batches of 2, the last padded) against the port's ``serve --mode lm``
    CLI and its ``greedy_generate`` on the reference's weights, bridged:
    the same stats' shape and the same greedy tokens."""
    args = argparse.Namespace(arch="hymba-1.5b", batch=2, requests=3, prompt_len=8, gen_len=6,
                              seed=0, device="cpu")
    seen, inits = [], []
    pack, get_adapter = JS.pack_batches, JS.get_adapter
    monkeypatch.setattr(JS, "pack_batches", lambda reqs, b: seen.append(reqs) or pack(reqs, b))
    monkeypatch.setattr(JS, "get_adapter", lambda c: dataclasses.replace(
        get_adapter(c), init=lambda key: inits.append(get_adapter(c).init(key)) or inits[-1]))
    jstats = JS.serve_lm(args)
    want = np.stack([r.result for r in seen[0]])

    TS.main(["--mode", "lm", "--arch", args.arch, "--device", "cpu", "--requests", "3",
             "--batch", "2", "--prompt-len", "8", "--gen-len", "6"])
    out = capsys.readouterr().out
    assert "'requests': 3" in out and f"'gen_shape': {jstats['gen_shape']}" in out

    ad = ST.get_adapter(get_lm_config(args.arch, "smoke"))
    params = bridge.lm_params_from_numpy(_np_tree(inits[0]))
    reqs = TS.make_lm_requests(args, ad.cfg.vocab_size)
    got = []
    for group in TS.pack_batches(reqs, args.batch):
        toks = np.stack([g.payload for g in group] + [group[-1].payload] * (2 - len(group)))
        got.append(TS.greedy_generate(ad, params, torch.from_numpy(toks), args.gen_len)
                   .numpy()[: len(group)])
    np.testing.assert_array_equal(np.concatenate(got), want)
