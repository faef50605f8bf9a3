"""The port's LM layer skipping (``core/lm_skip.py``) against the JAX package's.

``skip_decode`` runs on the reference test's 6-layer ``mini6`` model
(``tests/test_lm_skip.py``) and on ``mini_ring``, 3 units of a local(4) +
global pattern with a tail layer, per-head q / k norms, post-norms,
sqrt(d) input scaling and tied embeddings (the write-through's k norm and
ring slot, and the tail), over 8 tokens, under ``SkipPlan(1, 1, 2)`` and
``SkipPlan(1, 1, 3)``.  The reference's ``skip_decode`` is jitted once per
case at ``FAST_COMPILE`` (as in ``tests/test_torch_lm.py``) and its weights
are bridged (``bridge.lm_params_from_numpy``).  Tolerances, and the largest
deviation measured on the CPU:

* the logits at every position relative to max |logit|: 1e-4 (measured
  7.8e-7);
* after the last step the whole state, every layer's K / V cache (the
  write-through's slots included) and the delta: 1e-5 absolute (measured
  3.3e-6);
* ``flops_reduction``: equal, for every transformer arch at both sizes.

Besides: the FULL steps equal exact ``lm_decode``; ``SkipPlan.validate``
refuses with the reference's three messages; the recurrent families are
refused (``ValueError`` here; the reference raises ``KeyError`` on
xlstm's missing ``slot0``, and its ``validate`` refuses hymba's two
layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import GLOBAL as J_GLOBAL
from repro.common.types import LMConfig as JLMConfig
from repro.common.types import local as j_local
from repro.configs import get_lm_config as j_get_lm_config
from repro.core import lm_skip as JLS
from repro.launch import steps as JST
from repro.models import transformer as JTR
from repro_torch import bridge
from repro_torch.common.tree import tree_leaves
from repro_torch.common.types import GLOBAL, LMConfig, local
from repro_torch.configs import ARCH_IDS, get_lm_config
from repro_torch.core import lm_skip as LS
from repro_torch.launch.steps import RECURRENT_FAMILIES
from repro_torch.models import transformer as TR

B, S = 2, 8
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
MINI6 = dict(name="mini6", family="dense", n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab_size=128, dtype="float32")
MINI_RING = dict(name="mini_ring", family="dense", n_layers=7, d_model=32, n_heads=4,
                 n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=96, act="gelu",
                 post_norm=True, qk_norm=True, embed_scale=True, tie_embeddings=True,
                 dtype="float32")
CONFIGS = {"mini6": (MINI6, None), "mini_ring": (MINI_RING, 4)}
TRANSFORMER_ARCHS = [a for a in ARCH_IDS
                     if get_lm_config(a, "smoke").family not in RECURRENT_FAMILIES]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(name):
    kw, window = CONFIGS[name]
    if window is None:
        return JLMConfig(**kw), LMConfig(**kw)
    return (JLMConfig(**kw, pattern=(j_local(window), J_GLOBAL)),
            LMConfig(**kw, pattern=(local(window), GLOBAL)))


@pytest.fixture(scope="module")
def models():
    """name -> (JAX config, port config, JAX params, bridged params)."""
    out = {}
    for name in CONFIGS:
        jcfg, cfg = _configs(name)
        key = jax.random.key(0)
        params = jax.jit(lambda k: JTR.init_lm(k, jcfg)).lower(key).compile(FAST_COMPILE)(key)
        out[name] = (jcfg, cfg, params, bridge.lm_params_from_numpy(jax.tree.map(np.asarray,
                                                                               params)))
    return out


def _toks(cfg):
    return np.random.default_rng(4).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("refresh", [2, 3])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_skip_decode_matches_the_reference(models, name, refresh):
    jcfg, cfg, jparams, params = models[name]
    plan, jplan = LS.SkipPlan(1, 1, refresh), JLS.SkipPlan(1, 1, refresh)
    toks = _toks(cfg)
    jstate = JLS.init_skip_state(jcfg, B, S)
    step = jax.jit(lambda p, s, t, pos: JLS.skip_decode(jcfg, p, s, t, pos, jplan)).lower(
        jparams, jstate, jnp.asarray(toks[:, 0]), jnp.asarray(0, jnp.int32)).compile(FAST_COMPILE)
    state = LS.init_skip_state(cfg, B, S, "cpu")
    exact_cache, worst = TR.init_cache(cfg, B, S, "cpu"), 0.0
    for pos in range(S):
        want, jstate = step(jparams, jstate, jnp.asarray(toks[:, pos]), jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, state = LS.skip_decode(cfg, params, state, torch.from_numpy(toks[:, pos]), pos,
                                        plan)
            exact, exact_cache = TR.lm_decode(cfg, params, exact_cache,
                                              torch.from_numpy(toks[:, pos]), pos)
        worst = max(worst, _rel(got, want))
        if pos == 0:  # nothing skipped yet: the exact decode
            assert _rel(got, exact) <= 1e-6
    assert worst <= LOGIT_TOL
    got_leaves = tree_leaves((state["cache"], state["delta"]))
    want_leaves = jax.tree.leaves((jstate["cache"], jstate["delta"]))
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= CACHE_TOL
    assert float(state["delta"].abs().max()) > 0


@pytest.mark.parametrize("refresh", [2, 3, 4])
@pytest.mark.parametrize("variant", ["smoke", "full"])
@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_flops_reduction_equals_the_reference(arch, variant, refresh):
    """Equal as floats, whether or not the plan validates for the arch
    (neither package validates here)."""
    cfg, jcfg = get_lm_config(arch, variant), j_get_lm_config(arch, variant)
    plan = LS.SkipPlan(1, 1, refresh)
    assert LS.flops_reduction(cfg, plan) == JLS.flops_reduction(
        jcfg, JLS.SkipPlan(1, 1, refresh))


@pytest.mark.parametrize("plan", [(6, 1, 2), (0, 1, 2), (1, 1, 1)])
def test_validate_refuses_with_the_reference_message(plan):
    with pytest.raises(ValueError) as jerr:
        JLS.SkipPlan(*plan).validate(6)
    with pytest.raises(ValueError) as terr:
        LS.SkipPlan(*plan).validate(6)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("arch,jerror,jmatch", [
    ("xlstm-350m", KeyError, "slot0"),
    ("hymba-1.5b", ValueError, "front\\+back"),  # 2 layers: its validate refuses first
])
def test_recurrent_families_are_refused(arch, jerror, jmatch):
    cfg = get_lm_config(arch, "smoke")
    with pytest.raises(ValueError, match=f"not the '{cfg.family}' family"):
        LS.init_skip_state(cfg, B, S, "cpu")
    with pytest.raises(ValueError, match=f"not the '{cfg.family}' family"):
        LS.skip_decode(cfg, {}, {}, torch.zeros((B,), dtype=torch.int64), 0, LS.SkipPlan(1, 1, 2))
    # the reference fails where it first cannot go on
    jcfg = j_get_lm_config(arch, "smoke")
    jparams = jax.eval_shape(JST.get_adapter(jcfg).init, jax.random.key(0))
    jparams = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jparams)
    with pytest.raises(jerror, match=jmatch):
        JLS.skip_decode(jcfg, jparams, JLS.init_skip_state(jcfg, B, S),
                        jnp.zeros((B,), jnp.int32), jnp.asarray(0, jnp.int32),
                        JLS.SkipPlan(1, 1, 2))


def test_mini_ring_exercises_the_ring_and_the_tail(models):
    _, cfg, _, _ = models["mini_ring"]
    assert TR._pattern_split(cfg) == (3, 1)
    assert cfg.pattern[0].window == 4 < S
