"""The port's LM transformer family against the JAX package's, on the CPU.

For every transformer-family arch (dense, moe, audio, vlm) at its SMOKE
size, the JAX reference runs once per module (``_reference``: a jitted
init from ``jax.random.key(0)``, a jitted forward, one jitted ``make_train_step``
step, 16 teacher-forced decode steps), without a mesh, and its weights
are bridged to the port (``bridge.lm_params_from_numpy``).  Inputs come
from numpy with fixed seeds: token ids, or frame / patch embeddings for
the stub frontends.  Tolerances, and the largest deviation measured:

* forward logits, relative to max |logit|: 1e-4 (measured at most
  6.0e-7); aux loss 1e-5 relative (1.1e-7);
* one train step (lr 1e-3, warmup 1): the loss 1e-5 relative (2.8e-7);
  AdamW's m and v within 1e-4 of each leaf's largest value (2.5e-6); the
  parameters within 0.5 lr (0.078 lr: Adam's first step moves an element
  by about lr whatever |g| is, so a float32 difference in a tiny gradient
  moves it by a share of lr);
* decode logits against the reference's decode, 1e-4 (5.8e-7); the port's
  teacher-forced decode against its own forward, 1e-4 (4.2e-7), under the
  reference's drop-free MoE capacity (``tests/test_models_lm.py``);
* bf16 (gemma3-1b and mixtral-8x22b SMOKE with ``dtype="bfloat16"``):
  logits and aux within 2e-2 of max |logit| and of aux (measured 7.5e-3
  and 5.4e-5).

Besides: every arch and variant's config, parameter counts, layer specs
and cells equal the reference's; the initial parameter tree (keys, shapes,
dtypes) is the reference's; the chunked losses equal plain cross
entropy; the ``ssm`` / ``hybrid`` archs build and train a step; the
musicgen ``train --mode lm`` fault raises the reference's ``ValueError`` in
both packages; ``train --mode lm`` resumes from its checkpoint, and
checkpoints restore across the packages; ``serve_lm``'s greedy tokens
equal the reference's ``serve_lm`` on the same weights.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.common.types import SHAPE_CELLS as J_SHAPE_CELLS
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import LONG_CONTEXT_OK as J_LONG_CONTEXT_OK
from repro.configs import cells_for as j_cells_for
from repro.configs import get_lm_config as j_get_lm_config
from repro.launch import serve as JS
from repro.launch import steps as JST
from repro.launch import train as JT
from repro.models import transformer as JTR
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_adamw as j_init_adamw
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.tree import tree_leaves, tree_leaves_with_path
from repro_torch.common.types import SHAPE_CELLS
from repro_torch.configs import ARCH_IDS, LONG_CONTEXT_OK, cells_for, get_lm_config
from repro_torch.launch import serve as TS
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TT
from repro_torch.models import transformer as TR
from repro_torch.optim import AdamWConfig, init_adamw

TRANSFORMER_ARCHS = [a for a in ARCH_IDS
                     if get_lm_config(a, "smoke").family not in ST.RECURRENT_FAMILIES]
RECURRENT_ARCHS = [a for a in ARCH_IDS if a not in TRANSFORMER_ARCHS]
B, S = 2, 16
OPT = dict(lr=1e-3, total_steps=10, warmup_steps=1)
#: XLA options of the reference compiles: its HLO, compiled faster
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
#: logits relative to max |logit|; aux and loss relative; m and v as a
#: fraction of each leaf's largest value; parameters in units of lr
LOGIT_TOL, LOSS_RTOL, MV_TOL, PARAM_TOL = 1e-4, 1e-5, 1e-4, 0.5
BF16_LOGIT_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.frontend_stub:
        return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _labels(cfg, seed=2):
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _tokens(cfg, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def _reference(arch: str, dtype: str | None = None) -> dict:
    """The JAX package's results on ``arch``'s SMOKE config (optionally in
    another dtype), as numpy."""
    cfg = j_get_lm_config(arch, "smoke")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    ad = JST.get_adapter(cfg)
    key = jax.random.key(0)
    params = _jit(ad.init, key)(key)
    x = jnp.asarray(_inputs(cfg))
    logits, aux = _jit(ad.forward, params, x)(params, x)
    out = dict(arch=arch, cfg=cfg, params=_np_tree(params),
               logits=np.asarray(logits, np.float32), aux=float(aux))
    if dtype is not None:
        return out
    batch = {"inputs": x, "labels": jnp.asarray(_labels(cfg))}
    opt = j_init_adamw(params)
    step = JST.make_train_step(ad, JAdamWConfig(**OPT), remat=False)
    p1, o1, loss = _jit(step, params, opt, batch)(params, opt, batch)
    out.update(loss=float(loss), p1=_np_tree(p1), m1=_np_tree(o1.m), v1=_np_tree(o1.v))
    cache, toks, step_logits = ad.init_cache(B, S), jnp.asarray(_tokens(cfg)), []
    decode = _jit(ad.decode, params, cache, toks[:, 0], jnp.asarray(0, jnp.int32))
    for pos in range(S):
        lg, cache = decode(params, cache, toks[:, pos], jnp.asarray(pos, jnp.int32))
        step_logits.append(np.asarray(lg, np.float32))
    out["decode"] = np.stack(step_logits, axis=1)
    return out


@pytest.fixture(scope="module")
def refs():
    """arch -> the reference's results, each computed on first use."""
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


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_registry_equals_the_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert LONG_CONTEXT_OK == J_LONG_CONTEXT_OK
    assert [dataclasses.asdict(c) for c in SHAPE_CELLS] == [
        dataclasses.asdict(c) for c in J_SHAPE_CELLS]
    assert len(TRANSFORMER_ARCHS) == 8 and RECURRENT_ARCHS == ["xlstm-350m", "hymba-1.5b"]


@pytest.mark.parametrize("variant", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_config_equals_the_reference(arch, variant):
    cfg, jcfg = get_lm_config(arch, variant), j_get_lm_config(arch, variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert (cfg.q_dim, cfg.kv_dim) == (jcfg.q_dim, jcfg.kv_dim)
    assert [dataclasses.asdict(s) for s in cfg.layer_specs()] == [
        dataclasses.asdict(s) for s in jcfg.layer_specs()]
    assert [dataclasses.asdict(c) for c in cells_for(arch)] == [
        dataclasses.asdict(c) for c in j_cells_for(arch)]
    if variant == "full":
        assert cfg.dtype == "bfloat16"


def test_gemma3_full_is_the_full_width_model():
    cfg = get_lm_config("gemma3-1b", "full")
    assert (cfg.d_model, cfg.head_dim, cfg.vocab_size, cfg.n_layers) == (1152, 256, 262144, 26)
    assert 0.99e9 < cfg.param_count() < 1.01e9
    assert TR._pattern_split(cfg) == (4, 2)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_init_lm_tree_is_the_reference_tree(arch, dtype):
    """Same keys, shapes and dtypes leaf for leaf (a bf16 model keeps its
    norms, q / k norms and router in float32); the bridge keeps each
    leaf's dtype."""
    jcfg = dataclasses.replace(j_get_lm_config(arch, "smoke"), dtype=dtype)
    cfg = dataclasses.replace(get_lm_config(arch, "smoke"), dtype=dtype)
    jshapes = jax.eval_shape(lambda: JTR.init_lm(jax.random.key(0), jcfg))
    want = [(jax.tree_util.keystr(k), v.shape, str(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(jshapes)]
    params = TR.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    got = [(k, tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in tree_leaves_with_path(params)]
    assert got == want
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jshapes)
    bridged = [(k, str(v.dtype).removeprefix("torch."))
               for k, v in tree_leaves_with_path(bridge.lm_params_from_numpy(zeros))]
    assert bridged == [(k, d) for k, _, d in want]


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_forward_logits_and_aux_match(refs, arch):
    ref = _ref(refs, arch)
    cfg, ad, params = _port(ref)
    with torch.no_grad():
        logits, aux = ad.forward(params, torch.from_numpy(_inputs(cfg)))
    assert logits.shape == ref["logits"].shape
    assert _rel(logits, ref["logits"]) <= LOGIT_TOL
    assert abs(float(aux) - ref["aux"]) <= LOSS_RTOL * max(abs(ref["aux"]), 1e-30)
    if cfg.moe is not None:
        assert float(aux) > 0


def _port_step(ref):
    cfg, ad, params = _port(ref)
    batch = {"inputs": torch.from_numpy(_inputs(cfg)), "labels": torch.from_numpy(_labels(cfg))}
    step = ST.make_train_step(ad, AdamWConfig(**OPT), remat=False)
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


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_train_step_loss_matches(refs, port_steps, arch):
    _, _, loss = port_steps(arch)
    want = _ref(refs, arch)["loss"]
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want)


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_train_step_moments_match(refs, port_steps, arch):
    _, opt, _ = port_steps(arch)
    ref = _ref(refs, arch)
    for name in ("m", "v"):
        for got, want in zip(tree_leaves(getattr(opt, name)), jax.tree.leaves(ref[name + "1"])):
            assert float(np.abs(got.numpy() - want).max()) <= MV_TOL * float(
                np.abs(want).max()), name


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_train_step_params_match(refs, port_steps, arch):
    params, opt, _ = port_steps(arch)
    assert int(opt.step) == 1
    for got, want in zip(tree_leaves(params), jax.tree.leaves(_ref(refs, arch)["p1"])):
        assert float(np.abs(got.numpy() - want).max()) <= PARAM_TOL * OPT["lr"]


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_decode_matches_the_reference(refs, arch):
    """16 teacher-forced steps from an empty cache: the local(8) rings of
    gemma2, gemma3 and mixtral wrap once."""
    ref = _ref(refs, arch)
    cfg, ad, params = _port(ref)
    toks = torch.from_numpy(_tokens(cfg))
    cache, got = ad.init_cache(B, S, "cpu"), []
    with torch.no_grad():
        for pos in range(S):
            lg, cache = ad.decode(params, cache, toks[:, pos], pos)
            got.append(lg)
    assert _rel(torch.stack(got, dim=1), ref["decode"]) <= LOGIT_TOL


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_teacher_forced_decode_matches_own_forward(refs, arch):
    """Under the reference's drop-free capacity (capacity_factor =
    num_experts): capacity drops are a batch-level policy that one-token
    decode does not share."""
    ref = _ref(refs, arch)
    cfg, _, params = _port(ref)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    ad = ST.get_adapter(cfg)
    toks = torch.from_numpy(_tokens(cfg))
    with torch.no_grad():
        full, _ = ad.forward(params, toks)
        cache, steps = ad.init_cache(B, S, "cpu"), []
        for pos in range(S):
            lg, cache = ad.decode(params, cache, toks[:, pos], pos)
            steps.append(lg)
    assert _rel(torch.stack(steps, dim=1), full) <= LOGIT_TOL


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x22b"])
def test_bf16_forward_matches(refs, arch):
    """The SMOKE config in bf16: weights, activations and logits in bf16,
    norm statistics, router and attention scores in float32."""
    ref = _ref(refs, arch, "bfloat16")
    cfg, ad, params = _port(ref)
    assert params["embed"].dtype == torch.bfloat16
    with torch.no_grad():
        logits, aux = ad.forward(params, torch.from_numpy(_inputs(cfg)))
    assert logits.dtype == torch.bfloat16
    assert _rel(logits.float(), ref["logits"]) <= BF16_LOGIT_TOL
    assert abs(float(aux) - ref["aux"]) <= BF16_LOGIT_TOL * max(abs(ref["aux"]), 1e-30)


def test_embed_scale_rounds_sqrt_d_to_bf16():
    """d_model 48: sqrt(48) is not a bf16 value.  The reference multiplies
    by it rounded to bf16; the port's ``_embed_in`` equals it bitwise,
    torch's plain ``h * 48 ** 0.5`` does not."""
    jcfg = dataclasses.replace(j_get_lm_config("gemma3-1b", "smoke"), dtype="bfloat16")
    cfg = dataclasses.replace(get_lm_config("gemma3-1b", "smoke"), dtype="bfloat16")
    emb = np.random.default_rng(5).normal(size=(cfg.vocab_size, cfg.d_model)).astype(np.float32)
    toks = _tokens(cfg)
    want = np.asarray(JTR._embed_in(jcfg, {"embed": jnp.asarray(emb, jnp.bfloat16)},
                                    jnp.asarray(toks)), np.float32)
    table = torch.from_numpy(emb).bfloat16()
    got = TR._embed_in(cfg, {"embed": table}, torch.from_numpy(toks)).float().numpy()
    np.testing.assert_array_equal(got, want)
    naive = (table[torch.from_numpy(toks).long()] * cfg.d_model**0.5).float().numpy()
    assert np.sum(naive != want) > 100


def test_remat_and_chunked_loss_step_equal_the_plain_step(refs):
    """``remat=True`` (each unit recomputed in the backward) and
    ``chunked_ce=8`` (the loss head over S-chunks) change no number."""
    ref = _ref(refs, "gemma3-1b")
    cfg, ad, params = _port(ref)
    batch = {"inputs": torch.from_numpy(_inputs(cfg)), "labels": torch.from_numpy(_labels(cfg))}
    plain = ST.make_train_step(ad, AdamWConfig(**OPT), remat=False)(
        params, init_adamw(params), batch)
    other = ST.make_train_step(ad, AdamWConfig(**OPT), remat=True, chunked_ce=8)(
        params, init_adamw(params), batch)
    assert abs(float(other[2]) - float(plain[2])) <= 1e-6 * abs(float(plain[2]))
    for a, b in zip(tree_leaves(other[1].m), tree_leaves(plain[1].m)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-30


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,chunk", [((2, 32, 50), 8), ((2, 30, 50), 8), ((2, 8, 50), 8),
                                         ((3, 64, 17), 16)])
def test_chunked_cross_entropy_equals_plain(shape, chunk):
    """S divisible by the chunk takes the chunked sum; otherwise (30 by 8,
    or S <= chunk) the plain loss; both equal the reference's."""
    rng = np.random.default_rng(6)
    logits = rng.normal(size=shape).astype(np.float32) * 3
    labels = rng.integers(0, shape[-1], size=shape[:-1]).astype(np.int32)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    plain = float(ST.cross_entropy(tl, tlab))
    assert float(ST.cross_entropy_chunked(tl, tlab, chunk)) == pytest.approx(plain, rel=1e-6)
    jplain = float(JST.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    assert plain == pytest.approx(jplain, rel=1e-6)
    assert float(JST.cross_entropy_chunked(jnp.asarray(logits), jnp.asarray(labels), chunk)) \
        == pytest.approx(plain, rel=1e-6)


def test_cross_entropy_from_hidden_equals_plain_with_gradients(refs):
    """gemma2-9b's softcapped tied head over chunks of 8: the loss and its
    gradient (chunks recomputed in the backward) equal the plain loss's."""
    ref = _ref(refs, "gemma2-9b")
    cfg, ad, params = _port(ref)
    labels = torch.from_numpy(_labels(cfg))
    with torch.no_grad():
        h, _ = ad.forward_hidden(params, torch.from_numpy(_inputs(cfg)))
    grads = []
    for chunk in (8, 0):
        hh = h.clone().requires_grad_()
        loss = (ST.cross_entropy_from_hidden(ad, params, hh, labels, chunk) if chunk
                else ST.cross_entropy(ad.head_logits(params, hh), labels))
        loss.backward()
        grads.append((float(loss.detach()), hh.grad))
    (lc, gc), (lp, gp) = grads
    assert lc == pytest.approx(lp, rel=1e-6)
    assert float((gc - gp).abs().max()) <= 1e-6 * float(gp.abs().max())


# ---------------------------------------------------------------------------
# adapters and launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_families_raise_not_implemented(arch, capsys):
    """The recurrent families raise nothing: ``get_adapter`` builds the
    xlstm / hymba adapter and ``train --mode lm`` trains a step
    (``tests/test_torch_lm_recurrent.py`` holds them against the
    reference)."""
    ad = ST.get_adapter(get_lm_config(arch, "smoke"))
    assert ad.cfg.family in ST.RECURRENT_FAMILIES
    TT.main(["--mode", "lm", "--arch", arch, "--device", "cpu", "--steps", "1", "--batch", "2",
             "--seq", "16", "--no-sigterm"])
    out = capsys.readouterr().out
    assert f"[train] arch={arch} " in out and "[train] step=0 loss=" in out


def _lm_args(**kw):
    base = dict(mode="lm", arch="yi-6b", variant="smoke", steps=3, batch=2, seq=16, lr=3e-4,
                seed=0, ckpt_dir=None, save_every=2, log_every=1, no_sigterm=True,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_musicgen_train_raises_the_reference_value_error():
    """A known fault of the reference: ``token_batch``'s [B, S] labels
    against [B, S, 4, V] codebook logits.  The port raises it too."""
    with pytest.raises(ValueError, match="same number of dimensions; 3 vs. 4") as jerr:
        JT.train_lm(_lm_args(arch="musicgen-medium", steps=1))
    with pytest.raises(ValueError, match="same number of dimensions; 3 vs. 4") as terr:
        TT.train_lm(_lm_args(arch="musicgen-medium", steps=1))
    assert str(terr.value) == str(jerr.value)


def test_train_lm_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--mode", "lm", "--arch", "yi-6b", "--variant", "smoke", "--steps", "3",
            "--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--save-every", "2", "--log-every", "1", "--no-sigterm"]
    TT.main(argv)
    out = capsys.readouterr().out
    assert "[train] step=2 " in out and "resumed" not in out
    assert CheckpointManager(str(tmp_path)).list_steps() == [2]
    TT.main(argv[:7] + ["4"] + argv[8:])
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out
    assert "[train] step=1 " not in out and "[train] step=3 " in out
    assert CheckpointManager(str(tmp_path)).list_steps() == [2, 4]


def test_lm_checkpoints_restore_across_the_packages(tmp_path):
    """The port's train_lm state restores into the reference's template,
    and the reference's state into the port's, value for value."""
    res = TT.train_lm(_lm_args(ckpt_dir=str(tmp_path / "port"), steps=2))
    state = res["state"]
    cfg = j_get_lm_config("yi-6b", "smoke")
    jparams = JTR.init_lm(jax.random.key(1), cfg)
    jtemplate = {"params": jparams, "opt": j_init_adamw(jparams)}
    step, jstate = JCheckpointManager(str(tmp_path / "port")).restore_latest(jtemplate)
    assert step == 2
    for got, want in zip(jax.tree.leaves(jstate), tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())

    JCheckpointManager(str(tmp_path / "jax")).save(7, jtemplate)
    template = {"params": state["params"], "opt": init_adamw(state["params"])}
    step, tstate = CheckpointManager(str(tmp_path / "jax")).restore_latest(template)
    assert step == 7
    for got, want in zip(tree_leaves(tstate), jax.tree.leaves(jtemplate)):
        assert got.dtype == (torch.int32 if want.dtype == jnp.int32 else torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_lm_greedy_tokens_equal_the_reference(monkeypatch):
    """The reference's ``serve_lm`` (gemma3-1b SMOKE, 6 requests in
    batches of 4, the last padded) against the port's ``greedy_generate``
    on its weights, bridged, over the same prompts."""
    args = argparse.Namespace(arch="gemma3-1b", batch=4, requests=6, prompt_len=12, gen_len=10,
                              seed=0, device="cpu")
    seen, inits = [], []
    pack, get_adapter = JS.pack_batches, JS.get_adapter
    monkeypatch.setattr(JS, "pack_batches", lambda reqs, b: seen.append(reqs) or pack(reqs, b))
    monkeypatch.setattr(JS, "get_adapter", lambda c: dataclasses.replace(
        get_adapter(c), init=lambda key: inits.append(get_adapter(c).init(key)) or inits[-1]))
    stats = JS.serve_lm(args)
    assert stats["gen_shape"] == (10,)
    want = np.stack([r.result for r in seen[0]])

    cfg = get_lm_config(args.arch, "smoke")
    ad = ST.get_adapter(cfg)
    params = bridge.lm_params_from_numpy(_np_tree(inits[0]))
    reqs = TS.make_lm_requests(args, cfg.vocab_size)
    np.testing.assert_array_equal(np.stack([r.payload for r in reqs]),
                                  np.stack([r.payload for r in seen[0]]))
    got = []
    for group in TS.pack_batches(reqs, args.batch):
        toks = np.stack([g.payload for g in group] + [group[-1].payload] * (4 - len(group)))
        got.append(TS.greedy_generate(ad, params, torch.from_numpy(toks), args.gen_len)
                   .numpy()[: len(group)])
    np.testing.assert_array_equal(np.concatenate(got), want)


def test_serve_lm_cli_on_cpu(capsys):
    TS.main(["--mode", "lm", "--arch", "mixtral-8x22b", "--device", "cpu", "--requests", "5",
             "--batch", "4", "--gen-len", "6"])
    out = capsys.readouterr().out
    assert "'mode': 'lm'" in out and "'requests': 5" in out and "'gen_shape': (6,)" in out
    with pytest.raises(SystemExit, match="--http currently serves --mode diffusion only"):
        TS.main(["--mode", "lm", "--device", "cpu", "--http", "127.0.0.1:0"])
