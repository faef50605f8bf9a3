"""The port's diffusion training against the JAX package's.

Train steps: ``repro``'s ``make_unet_train_step`` (jitted, at XLA's backend
optimisation level 0 to cut its compile time; the HLO is the reference's)
and the port's, fed the same bridged sd_toy weights, the same batches
(``latent_batch``'s latents, prompt embeddings from numpy: see
:func:`_batch`) and the same draws: the port takes the timesteps and noise
the reference draws from its own key (``kt, ke = split(sub)``), recomputed
here.  Two steps each, with ``AdamWConfig`` as ``train_unet`` builds it for
2 steps (lr 3e-4, warmup 1).  Measured at steps 1 / 2:

* float32: the loss within 1e-5 relative (measured 1.8e-7 / 0); m and v
  within 1e-4 of each leaf's largest value (m 2.9e-6 / 3.8e-5, v 4.7e-6 /
  8.5e-6); parameters within 0.5 lr (0.081 lr): Adam's first steps move an
  element by about lr * sign(g) whatever |g| is, so where |g| is near
  Adam's eps a float32 gradient difference moves the element by a share of
  lr;
* float32 with ``compress=True``: the loss as above (1.8e-7 / 9.0e-8);
  where a gradient element's int8 code rounds to the other side, m moves
  by one code (1/127 of the leaf's largest value) and v by up to two, a
  step: m beyond 1e-4 on 53 / 473 elements, at most 7.9e-3 / 9.0e-3; v on
  48 / 423, at most 8.9e-3 / 7.8e-3; parameters within 2 lr (1.00 / 1.02
  lr), beyond 0.5 lr on 5 / 5 elements (a code between 0 and +-1 flips
  Adam's first step);
* bfloat16 on both sides (``dataclasses.replace(sd_toy, dtype="bfloat16")``):
  the port rounds each bf16 leaf's gradient and updated value as JAX's
  casts do.  The loss 1.8e-7 / 3.6e-7; where a gradient element rounds to
  the other bf16 value, m moves by 2**-8 of |g| and v by 2**-7: m beyond
  1e-4 on 943 / 7569 elements of 3.1 M, at most 3.6e-3 / 3.8e-3; v on
  172 / 1056, at most 5.4e-3 / 5.9e-3; 63 / 307 parameters differ, each
  by at most 0.5 lr plus one bf16 step (up to 0.41 lr, three bf16 steps
  on a small parameter: the float32 effect above, then the rounding).

Besides: ``param_dtypes(sd_v14)`` is ``jax.eval_shape(init_unet)``'s
dtypes; ``vae_encode`` within 2e-5 (measured 9.5e-7); ``train_unet`` on the
CPU trains, checkpoints and resumes; each kernel wrapper refuses an operand
that requires grad under grad mode; ``--mode lm`` refuses the recurrent
archs (the transformer family trains: ``tests/test_torch_lm.py``); the
example runs in-process at sd_toy.
"""
import argparse
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import DiffusionConfig as JDiffusionConfig
from repro.configs import get_unet_config as j_get_unet_config
from repro.data.pipeline import DataConfig, latent_batch
from repro.launch import train as JT
from repro.models import unet as JU
from repro.models import vae as JV
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_adamw as j_init_adamw
from repro.optim import init_compression as j_init_compression
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.tree import tree_leaves, tree_leaves_with_path
from repro_torch.common.types import DiffusionConfig
from repro_torch.configs import get_unet_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.fused_matmul.ops import fused_matmul
from repro_torch.kernels.stream_norm.ops import stream_group_norm, stream_norm
from repro_torch.kernels.uniconv.ops import uniconv
from repro_torch.launch import train as TT
from repro_torch.models import unet as TU
from repro_torch.models import vae as TV
from repro_torch.optim import AdamWConfig, init_adamw, init_compression
from test_torch_unet import _numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JTOY = j_get_unet_config("sd_toy")
TOY = get_unet_config("sd_toy")
STEPS, BATCH, SEED = 2, 2, 0
OPT = dict(lr=3e-4, total_steps=STEPS, warmup_steps=min(20, STEPS // 5 + 1))
VARIANTS = {"f32": ("float32", False), "f32_compress": ("float32", True),
            "bf16": ("bfloat16", False)}
#: XLA options of the reference compile: its float32 HLO, compiled faster
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
#: the loss, relative; m and v, as a fraction of each leaf's largest value;
#: parameters, in units of the learning rate
LOSS_RTOL, MV_TOL, PARAM_TOL = 1e-5, 1e-4, 0.5
#: where one element's int8 code (compress) or its bf16 gradient rounds to
#: the other side, m moves by one code (1/127 of the leaf's largest value)
#: or one bf16 step (2**-8 of |g|), v by about twice that, at each step so
#: far; on at most MV_FEW elements of sd_toy's 3.1 M.  In bf16 the step-1
#: parameters differ by a bf16 step on a few elements, so the step-2
#: gradients differ by more than float32 rounding and round apart more often
ONE_STEP = {"f32_compress": {"m": 1 / 127, "v": 2 / 127}, "bf16": {"m": 2.0**-8, "v": 2.0**-7}}
MV_FEW = {"f32_compress": 2000, "bf16": 20000}
#: parameters beyond PARAM_TOL (compress: a code that flipped between 0 and
#: +-1 flips Adam's first step) or unequal (bf16), at most
PARAM_FEW = 2000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _class_ctx(class_id):
    """The context ``repro.launch.train.train_unet`` builds for ``class_id``."""
    ctx = jax.nn.one_hot(class_id % 8, 8)[:, None, :].repeat(JTOY.ctx_len, 1)
    return np.asarray(jnp.pad(ctx, ((0, 0), (0, 0), (0, JTOY.ctx_dim - 8))), np.float32)


def _batch(step: int):
    """``train_unet``'s latents at ``step``, with prompt embeddings from
    numpy: the one-hot class context repeats one row over every context
    token, so cross attention's weights are uniform whatever q and k are,
    and the exact gradients of its q / k projections and of the layer norm
    before them are 0.  Both packages then hold float32 noise of ~1e-11
    there, which Adam scales to +-lr: no test of the two could agree."""
    dc = DataConfig(global_batch=BATCH, seq_len=0, vocab_size=8, seed=SEED)
    nb = latent_batch(dc, step, size=JTOY.latent_size)
    np.testing.assert_array_equal(TT.class_context(TOY, nb["class_id"]),
                                  _class_ctx(nb["class_id"]))
    rng = np.random.default_rng(100 + step)
    ctx = (rng.normal(size=(BATCH, JTOY.ctx_len, JTOY.ctx_dim)) * 0.5).astype(np.float32)
    return nb["latents"], ctx


def _draws(sub, x0):
    """The reference step's (t, eps) from its key ``sub``."""
    kt, ke = jax.random.split(sub)
    t = jax.random.randint(kt, (x0.shape[0],), 0, JDiffusionConfig().timesteps_train)
    return np.asarray(t), np.asarray(jax.random.normal(ke, x0.shape, x0.dtype))


def _np(tree):
    return [np.asarray(x).astype(np.float32) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module", params=list(VARIANTS))
def runs(request):
    """Per step, (loss, params, m, v) as float32 numpy leaves, from the
    reference and from the port, and the step-1 learning rate."""
    dtype, compress = VARIANTS[request.param]
    jcfg = dataclasses.replace(JTOY, dtype=dtype)
    specs = jax.eval_shape(lambda k: JU.init_unet(k, jcfg), jax.random.key(0))
    tree = _numpy_tree(lambda k: JU.init_unet(k, jcfg), seed=0)
    jp = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, specs)
    tp = bridge.unet_params_from_numpy(jax.tree.map(np.asarray, jp))
    jopt, topt = j_init_adamw(jp), init_adamw(tp)
    jcomp = j_init_compression(jp) if compress else None
    tcomp = init_compression(tp) if compress else None
    jstep = jax.jit(JT.make_unet_train_step(jcfg, JDiffusionConfig(), JAdamWConfig(**OPT),
                                            compress=compress))
    tstep = TT.make_unet_train_step(dataclasses.replace(TOY, dtype=dtype), DiffusionConfig(),
                                    AdamWConfig(**OPT), compress=compress)
    key = jax.random.key(SEED + 1)
    out = {"jax": [], "port": [], "variant": request.param}
    compiled = None
    for step in range(STEPS):
        x0, ctx = _batch(step)
        jbatch = {"latents": jnp.asarray(x0), "ctx": jnp.asarray(ctx)}
        key, sub = jax.random.split(key)
        if compiled is None:
            compiled = jstep.lower(jp, jopt, jcomp, jbatch, sub).compile(FAST_COMPILE)
        jp, jopt, jcomp, jloss = compiled(jp, jopt, jcomp, jbatch, sub)
        t, eps = _draws(sub, jbatch["latents"])
        tbatch = {"latents": torch.from_numpy(x0), "ctx": torch.from_numpy(ctx)}
        tp, topt, tcomp, tloss = tstep(tp, topt, tcomp, tbatch, torch.from_numpy(t).long(),
                                       torch.from_numpy(eps))
        out["jax"].append((float(jloss), _np(jp), _np(jopt.m), _np(jopt.v)))
        out["port"].append((float(tloss), [p.numpy() for p in tree_leaves(tp)],
                            [m.numpy() for m in tree_leaves(topt.m)],
                            [v.numpy() for v in tree_leaves(topt.v)]))
        assert int(topt.step) == int(jopt.step) == step + 1
    return out


def _outliers(got, ref, tol):
    """(elements whose error exceeds ``tol`` of their leaf's largest value,
    the largest error as a fraction of its leaf's largest value)."""
    n, worst = 0, 0.0
    for g, r in zip(got, ref):
        rel = np.abs(g - r) / max(np.abs(r).max(), 1e-30)
        n += int((rel > tol).sum())
        worst = max(worst, float(rel.max()))
    return n, worst


def _bf16_step(x):
    """The spacing of bfloat16 values at each (bf16-valued) element of ``x``."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def test_train_steps_loss_matches(runs):
    for (jl, *_), (tl, *_) in zip(runs["jax"], runs["port"]):
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)


def test_train_steps_moments_match(runs):
    variant = runs["variant"]
    for step, ((_, _, jm, jv), (_, _, tm, tv)) in enumerate(zip(runs["jax"], runs["port"]), 1):
        for name, got, ref in (("m", tm, jm), ("v", tv, jv)):
            n, worst = _outliers(got, ref, MV_TOL)
            if variant == "f32":
                assert n == 0, (name, worst)
            else:  # an int8 code or a bf16 gradient step a step, on a few elements
                assert n <= MV_FEW[variant], (name, n)
                assert worst <= MV_TOL + step * ONE_STEP[variant][name], (name, worst)


def test_train_steps_params_match(runs):
    lr = OPT["lr"]
    for (_, jp, _, _), (_, tp, _, _) in zip(runs["jax"], runs["port"]):
        diff = [np.abs(t - j) for t, j in zip(tp, jp)]
        if runs["variant"] == "f32":
            assert max(float(d.max()) for d in diff) <= PARAM_TOL * lr
        elif runs["variant"] == "f32_compress":
            assert max(float(d.max()) for d in diff) <= 2 * lr
            assert sum(int((d > PARAM_TOL * lr).sum()) for d in diff) <= PARAM_FEW
        else:
            assert all((d <= PARAM_TOL * lr + _bf16_step(j)).all() for d, j in zip(diff, jp))
            assert sum(int((d > 0).sum()) for d in diff) <= PARAM_FEW


def test_param_dtypes_equal_the_reference():
    cfg = j_get_unet_config("sd_v14")
    specs = jax.eval_shape(lambda k: JU.init_unet(k, cfg), jax.random.key(0))
    ref = sorted((jax.tree_util.keystr(p), str(s.dtype))
                 for p, s in jax.tree_util.tree_flatten_with_path(specs)[0])
    got = sorted((k, str(d).removeprefix("torch."))
                 for k, d in tree_leaves_with_path(TU.param_dtypes(get_unet_config("sd_v14"))))
    assert got == ref
    assert {d for _, d in got} == {"float32", "bfloat16"} and len(got) == 622
    assert {str(d) for d in tree_leaves(TU.param_dtypes(TOY))} == {"torch.float32"}


def test_vae_encode_matches_jax():
    tree = _numpy_tree(lambda k: JV.init_vae(k, latent_channels=TOY.in_channels), seed=3)
    jvae, tvae = jax.tree.map(jnp.asarray, tree), bridge.vae_params_from_numpy(tree)
    img = np.random.default_rng(9).normal(size=(2, 32 * 32, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: JV.vae_encode(p, x, (32, 32)))(jvae, jnp.asarray(img))
    got = TV.vae_encode(tvae, torch.from_numpy(img), (32, 32))
    for g, r in zip(got, ref):
        assert g.shape == (2, 8 * 8, TOY.in_channels)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=0)


def _train_args(tmp_path, **kw):
    base = dict(unet="sd_toy", steps=6, batch=2, lr=1e-3, seed=0, ckpt_dir=str(tmp_path),
                save_every=3, log_every=100, compress_grads=False, device="cpu")
    return argparse.Namespace(**{**base, **kw})


def test_train_unet_trains_checkpoints_and_resumes(tmp_path, capsys):
    res = TT.train_unet(_train_args(tmp_path))
    assert res["start_step"] == 0 and len(res["step_s"]) == 6
    assert res["final_loss"] < res["first_loss"]
    cm = CheckpointManager(str(tmp_path))
    assert cm.list_steps() == [3, 6]
    # the newest checkpoint is the live state, bitwise
    params0 = TU.init_unet(TOY, torch.Generator().manual_seed(7))
    step, state = cm.restore_latest({"params": params0, "opt": init_adamw(params0)})
    assert step == 6
    for (k, a), b in zip(tree_leaves_with_path(state), tree_leaves(res["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    res2 = TT.train_unet(_train_args(tmp_path, steps=8, save_every=2, compress_grads=True))
    assert "resumed from step 6" in capsys.readouterr().out
    assert res2["start_step"] == 6 and len(res2["step_s"]) == 2
    assert np.isfinite(res2["final_loss"]) and cm.list_steps() == [6, 8]


def test_cuda_backend_train_step_is_refused():
    params = TU.init_unet(TOY, torch.Generator().manual_seed(0))
    step = TT.make_unet_train_step(TOY, DiffusionConfig(), AdamWConfig(), backend="cuda")
    x0 = torch.zeros((1, TOY.latent_size**2, TOY.in_channels))
    batch = {"latents": x0, "ctx": torch.zeros((1, TOY.ctx_len, TOY.ctx_dim))}
    with pytest.raises(RuntimeError, match="'eager' backend"):
        step(params, init_adamw(params), None, batch, torch.tensor([3]), x0)


def _wrapper_calls():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    return {
        "uniconv": lambda w: uniconv(r(1, 16, 4), w, None, (4, 4), 3),
        "stream_norm": lambda w: stream_norm(r(3, 8), w[0, 0, :8]),
        "stream_group_norm": lambda w: stream_group_norm(r(1, 16, 8), w[0, 0, :8], w[0, 1, :8],
                                                         groups=2),
        "flash_attention": lambda w: flash_attention(w[:1, None, :, :4], r(1, 1, 4, 4),
                                                     r(1, 1, 4, 4)),
        "fused_matmul": lambda w: fused_matmul(r(3, 4), w[0, :, :5].contiguous()),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_an_operand_that_requires_grad(name):
    call = _wrapper_calls()[name]
    w = torch.randn((9, 4, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match=f"{name}: the kernel has no backward.*'eager'"):
        call(w)
    with torch.no_grad():
        call(w)  # no graph wanted: the wrapper runs
    call(w.detach())


def test_mode_lm_is_refused_and_no_gpu_needs_device_cpu(capsys):
    """``--mode lm`` runs an xlstm arch on ``--device cpu`` (it refuses no
    arch); without a GPU both modes need ``--device cpu``."""
    TT.main(["--mode", "lm", "--arch", "xlstm-350m", "--device", "cpu", "--steps", "2",
             "--batch", "2", "--seq", "16", "--log-every", "1", "--no-sigterm"])
    out = capsys.readouterr().out
    assert "[train] arch=xlstm-350m " in out and "[train] step=1 loss=" in out
    if not torch.cuda.is_available():
        for argv in (["--steps", "1"], ["--mode", "lm", "--steps", "1"]):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                TT.main(argv)


def test_train_unet_example_on_cpu(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_train_unet", os.path.join(REPO, "examples", "torch_train_unet.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    ex.main(["--device", "cpu", "--unet", "sd_toy", "--steps", "8", "--batch", "2",
             "--ckpt-dir", str(tmp_path), "--save-every", "4"])
    out = capsys.readouterr().out
    assert "[example] restored step 8" in out and "PAS vs full cosine=" in out
    assert "MAC_red=" in out
