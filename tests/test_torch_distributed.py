"""The port's rank-mesh train step against the JAX package's mesh step, on
the CPU.

The reference jits ``make_train_step`` over an Auto-axis
``jax.sharding.Mesh`` of 8 forced host devices, once per module, in a
subprocess of this file (``XLA_FLAGS`` with the device count replaced,
not appended to).  It and the port start from the same weights: the
reference's ``adapter.init(jax.random.key(0))``, written by this process,
device_put by the reference and bridged to the port
(``bridge.lm_params_from_numpy``), which ``shard_tree``s them per rank.
The port runs 8, 6 and 4 gloo ranks on the CPU (``launch/distributed.py``)
while the reference runs.

* (a) gemma3-1b SMOKE, ``examples/torch_distributed_smoke.py``'s run: 6
  steps at (4, 2), the checkpoint, and 3 steps at (3, 2) on the plan's 6
  rows from it; the reference continues its own step-6 state on its 3 x 2
  mesh.  The port runs with ``remat=True`` (the same arithmetic, and the
  layout (e) counts).
* (b) yi-6b, mixtral-8x22b (MoE, experts stored tensor-parallel) and
  qwen3-moe-235b-a22b (MoE, expert-parallel): 2 steps at (4, 2).
* Held after every step: the loss within 1e-5 relative; the parameters
  within 0.1 lr; AdamW's m and v within 1e-4 of each leaf's largest value.
* (c) every other SMOKE arch (all tile (2, 2)): one step at (2, 2) from
  the port's seed-0 init against the port's single-process step, under the
  same tolerances; musicgen raises the reference's ``ValueError`` on the
  mesh and off it.
* (d) each rank's parameter and AdamW bytes equal ``tree_shard_bytes``.
* (e) the collective bytes of (a)'s last (4, 2) step against
  ``launch/dryrun.py::collectives_from_specs``: reduce-scatters and the
  gradient all-reduces of leaves replicated over "data" equal; the MLP's
  forward and backward all-reduces equal its ``w_out`` term; the
  differences by design asserted exactly: attention and the embedding
  gathered over "model" too, no attention-output all-reduce, the
  embedding gathered over "data" once a step (kept for the head and the
  backward) where the model counts two, and the MLP's all-reduce once more
  in each checkpointed unit's recompute.
* (f) the example in-process with ``--device cpu``, and its refusal
  without a GPU.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reference's runs: (run id, arch, mesh, steps, global batch)
REF_RUNS = (
    ("gemma3-1b@4x2", "gemma3-1b", (4, 2), (0, 6), 8),
    ("gemma3-1b@3x2", "gemma3-1b", (3, 2), (6, 9), 6),  # continues the one before
    ("yi-6b@4x2", "yi-6b", (4, 2), (0, 2), 8),
    ("mixtral-8x22b@4x2", "mixtral-8x22b", (4, 2), (0, 2), 8),
    ("qwen3-moe-235b-a22b@4x2", "qwen3-moe-235b-a22b", (4, 2), (0, 2), 8),
)
REF_ARCHS = ("gemma3-1b", "yi-6b", "mixtral-8x22b", "qwen3-moe-235b-a22b")
LR = 1e-3
SEQ = 65
REF_TIMEOUT_S = 400


def _opt_kwargs():
    return dict(lr=LR, total_steps=20, warmup_steps=2)


def _eight_device_env() -> dict:
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count=")]
    return dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS=" ".join(["--xla_force_host_platform_device_count=8", *flags]),
                PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                            os.environ.get("PYTHONPATH", "")]))


def _reference(out_dir: str) -> None:
    """Run REF_RUNS on Auto-axis meshes; write each step's loss and state."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.common.sharding import set_activation_mesh
    from repro.configs import get_lm_config
    from repro.data.pipeline import DataConfig, token_batch
    from repro.launch.steps import get_adapter, make_train_step, opt_pspecs
    from repro.optim import AdamWConfig, init_adamw

    fast = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    out, state = {}, None
    for run, arch, shape, steps, gb in REF_RUNS:
        cfg = get_lm_config(arch, "smoke")
        ad = get_adapter(cfg)
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                                 ("data", "model"))
        set_activation_mesh(mesh)
        specs = ad.pspecs(shape[1])

        def place(s, m=mesh):
            return jax.tree.map(lambda p: NamedSharding(m, p), s,
                                is_leaf=lambda x: isinstance(x, JP))

        if steps[0] == 0:
            struct = jax.eval_shape(ad.init, jax.random.key(0))
            with np.load(os.path.join(out_dir, f"init_{arch}.npz")) as z:
                leaves = [z[jax.tree_util.keystr(p)] for p, _ in
                          jax.tree_util.tree_flatten_with_path(struct)[0]]
            params = jax.tree_util.tree_unflatten(jax.tree.structure(struct), leaves)
            state = {"params": params, "opt": init_adamw(params)}
        shard = {"params": place(specs), "opt": place(opt_pspecs(specs))}
        params = jax.device_put(state["params"], shard["params"])
        opt = jax.device_put(state["opt"], shard["opt"])
        step = jax.jit(make_train_step(ad, AdamWConfig(**_opt_kwargs()), remat=False),
                       in_shardings=(shard["params"], shard["opt"],
                                     NamedSharding(mesh, JP(("data",), None))),
                       out_shardings=(shard["params"], shard["opt"], NamedSharding(mesh, JP())))
        dc = DataConfig(global_batch=gb, seq_len=SEQ, vocab_size=cfg.vocab_size)
        compiled = None
        for s in range(*steps):
            nb = token_batch(dc, s)
            batch = {"inputs": jnp.asarray(nb["tokens"]), "labels": jnp.asarray(nb["labels"])}
            if compiled is None:
                compiled = step.lower(params, opt, batch).compile(fast)
            params, opt, loss = compiled(params, opt, batch)
            out[f"{run}|{s}|loss"] = np.asarray(loss)
            state = jax.device_get({"params": params, "opt": opt})
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
                out[f"{run}|{s}|{jax.tree_util.keystr(path)}"] = np.asarray(leaf, np.float32)
    np.savez(os.path.join(out_dir, "ref.npz"), **out)


if __name__ == "__main__":
    _reference(sys.argv[1])
    sys.exit(0)

from repro.configs import get_lm_config as j_get_lm_config  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.common.sharding import (  # noqa: E402
    P,
    entry_axes,
    is_spec,
    shard_bytes,
    tree_shard_bytes,
)
from repro_torch.common.tree import tree_leaves, tree_leaves_with_path  # noqa: E402
from repro_torch.common.types import Mesh, ShapeCell  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_lm_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, token_batch  # noqa: E402
from repro_torch.launch import distributed as D  # noqa: E402
from repro_torch.launch.dryrun import collectives_from_specs  # noqa: E402
from repro_torch.launch.specs import params_struct  # noqa: E402
from repro_torch.launch.steps import get_adapter, make_train_step, opt_pspecs  # noqa: E402
from repro_torch.optim import AdamWConfig, init_adamw  # noqa: E402

#: loss relative; parameters in units of lr; m and v as a fraction of each
#: leaf's largest value
LOSS_RTOL, PARAM_TOL, MV_TOL = 1e-5, 0.1, 1e-4
#: (c): the SMOKE archs neither (a) nor (b) runs; musicgen's loss raises
OTHER_ARCHS = tuple(a for a in ARCH_IDS if a not in REF_ARCHS and a != "musicgen-medium")
MUSICGEN_ERROR = "indices and arr must have the same number of dimensions"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _job(arch, mesh, steps, gb, **kw):
    return D.MeshJob(arch, mesh, steps, gb, seq_len=SEQ, opt=AdamWConfig(**_opt_kwargs()),
                     keep_states=True, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's runs, made once: (reference npz, port
    results by run id, the musicgen mesh error, (c)'s results by arch)."""
    d = str(tmp_path_factory.mktemp("distributed"))
    for arch in REF_ARCHS:
        ad = JST.get_adapter(j_get_lm_config(arch, "smoke"))
        params = jax.device_get(jax.jit(ad.init)(jax.random.key(0)))
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        np.savez(os.path.join(d, f"init_{arch}.npz"),
                 **{jax.tree_util.keystr(p): np.asarray(x) for p, x in flat})
        bridged = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, params))
        CheckpointManager(os.path.join(d, f"init_{arch}")).save(
            0, {"params": bridged, "opt": init_adamw(bridged)})
    log = open(os.path.join(d, "ref.log"), "w")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__), d], env=_eight_device_env(),
                           cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    try:
        cpu = D.choose_backend("cpu", 8)
        ckpt = os.path.join(d, "ckpt")
        w8 = D.run_ranks(D.train_on_mesh, ([
            _job("gemma3-1b", (4, 2), (0, 6), 8, remat=True, save=ckpt,
                 restore=os.path.join(d, "init_gemma3-1b")),
            *(_job(a, (4, 2), (0, 2), 8, restore=os.path.join(d, f"init_{a}"))
              for a in REF_ARCHS[1:])],), cpu, os.path.join(d, "rv8"))
        w6 = D.run_ranks(D.train_on_mesh, ([_job("gemma3-1b", (3, 2), (6, 9), 6, restore=ckpt)],),
                         D.choose_backend("cpu", 6), os.path.join(d, "rv6"))
        cpu4 = D.choose_backend("cpu", 4)
        w4 = D.run_ranks(D.train_on_mesh, ([_job(a, (2, 2), (0, 1), 8) for a in OTHER_ARCHS],),
                         cpu4, os.path.join(d, "rv4"))
        try:
            D.run_ranks(D.train_on_mesh, ([_job("musicgen-medium", (2, 2), (0, 1), 8)],), cpu4,
                        os.path.join(d, "rv4m"))
            musicgen = None
        except RuntimeError as e:
            musicgen = str(e)
        rc = ref.wait(timeout=REF_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
        log.close()
    with open(os.path.join(d, "ref.log")) as f:
        assert rc == 0, f.read()[-3000:]
    with np.load(os.path.join(d, "ref.npz")) as z:
        ref_out = dict(z)
    port = {run: [rank[i] for rank in w8] for i, (run, *_rest) in
            enumerate(r for r in REF_RUNS if r[0] != "gemma3-1b@3x2")}
    port["gemma3-1b@3x2"] = [rank[0] for rank in w6]
    other = {a: [rank[i] for rank in w4] for i, a in enumerate(OTHER_ARCHS)}
    return ref_out, port, musicgen, other


def _state_errors(port_state: dict, want: dict, key=lambda path: path) -> tuple[float, float]:
    """(max parameter deviation in lr, max m / v deviation over the leaf's
    largest value) of a gathered port state against ``want[key(path)]``."""
    p_err = mv_err = 0.0
    for path, x in tree_leaves_with_path(port_state):
        ref = want[key(path)]
        if path.startswith("['opt'].step"):
            assert int(x) == int(ref), path
        elif path.startswith("['params']"):
            p_err = max(p_err, float(np.abs(x - ref).max()) / LR)
        else:
            scale = max(float(np.abs(ref).max()), 1e-30)
            mv_err = max(mv_err, float(np.abs(x - ref).max()) / scale)
    return p_err, mv_err


REF_STEPS = [(run, s) for run, _, _, steps, _ in REF_RUNS for s in range(*steps)]


@pytest.mark.parametrize("run,step", REF_STEPS, ids=[f"{r}-step{s}" for r, s in REF_STEPS])
def test_mesh_step_matches_the_reference_mesh_step(runs, run, step):
    ref, port, _, _ = runs
    first = dict((r[0], r[3][0]) for r in REF_RUNS)[run]
    i = step - first
    losses = {tuple(rank["losses"]) for rank in port[run]}
    assert len(losses) == 1, f"ranks disagree on the loss: {losses}"
    loss, want = port[run][0]["losses"][i], float(ref[f"{run}|{step}|loss"])
    assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)
    p_err, mv_err = _state_errors(port[run][0]["states"][i], ref,
                                  key=lambda path: f"{run}|{step}|{path}")
    assert p_err <= PARAM_TOL, f"parameters off by {p_err} lr"
    assert mv_err <= MV_TOL, f"m / v off by {mv_err} of a leaf's largest value"


def _single_process(arch: str):
    cfg = get_lm_config(arch, "smoke")
    adapter = get_adapter(cfg)
    params = adapter.init(torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(adapter, AdamWConfig(**_opt_kwargs()), remat=False)
    nb = token_batch(DataConfig(global_batch=8, seq_len=SEQ, vocab_size=cfg.vocab_size), 0)
    return step(params, init_adamw(params), {"inputs": torch.from_numpy(nb["tokens"]),
                                             "labels": torch.from_numpy(nb["labels"])})


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_other_archs_match_the_single_process_step(runs, arch):
    _, _, _, other = runs
    params, opt, loss = _single_process(arch)
    want = {path: x.detach().float().numpy() if x.is_floating_point() else x.numpy()
            for path, x in tree_leaves_with_path({"params": params, "opt": opt})}
    got = other[arch][0]
    assert abs(got["losses"][0] - float(loss)) <= LOSS_RTOL * abs(float(loss))
    p_err, mv_err = _state_errors(got["states"][0], want)
    assert p_err <= PARAM_TOL and mv_err <= MV_TOL, (p_err, mv_err)


def test_musicgen_raises_the_reference_error_on_the_mesh_and_off_it(runs):
    _, _, musicgen, _ = runs
    assert musicgen is not None and MUSICGEN_ERROR in musicgen
    assert "ValueError" in musicgen
    with pytest.raises(ValueError, match=MUSICGEN_ERROR):
        _single_process("musicgen-medium")


RESIDENT = [r[0] for r in REF_RUNS] + [f"other:{a}" for a in OTHER_ARCHS]


@pytest.mark.parametrize("run", RESIDENT)
def test_each_rank_holds_its_tree_shard_bytes(runs, run):
    _, port, _, other = runs
    ranks = other[run.split(":", 1)[1]] if run.startswith("other:") else port[run]
    arch = run.split(":", 1)[1] if run.startswith("other:") else run.split("@")[0]
    shape = (2, 2) if run.startswith("other:") else tuple(map(int, run.split("@")[1].split("x")))
    adapter = get_adapter(get_lm_config(arch, "smoke"))
    specs = adapter.pspecs(shape[1])
    meta = params_struct(adapter)
    mesh = Mesh(shape, ("data", "model"))
    want_p = tree_shard_bytes(mesh, specs, meta)
    want_o = tree_shard_bytes(mesh, opt_pspecs(specs), init_adamw(meta))
    assert {(r["param_bytes"], r["opt_bytes"]) for r in ranks} == {(want_p, want_o)}


def test_collective_bytes_against_the_dry_run_model(runs):
    """gemma3-1b SMOKE at (4, 2), remat, 8 x 64 tokens."""
    _, port, _, _ = runs
    cfg = get_lm_config("gemma3-1b", "smoke")
    adapter = get_adapter(cfg)
    specs = adapter.pspecs(2)
    mesh = Mesh((4, 2), ("data", "model"))
    cell = ShapeCell("p15", SEQ - 1, 8, "train")
    model = collectives_from_specs(cfg, cell, mesh, specs)
    meta = params_struct(adapter)
    leaves = list(zip(tree_leaves_with_path(specs, is_leaf=is_spec), tree_leaves(meta)))

    def names(spec):
        return {a for e in spec for a in entry_axes(e)}

    # the model's all-reduce, in its parts: replicated leaves' gradients, and
    # the forward output and backward input gradient of each row-parallel
    # product (attention's wo, the MLP's w_out) at this rank's 2 x 64 rows
    grad_term = sum(shard_bytes(mesh, s, x) for (_, s), x in leaves if "data" not in names(s))
    rows = 8 // 4 * cell.seq_len

    def product_term(name):
        return sum(2 * rows * x.shape[-1] * x.element_size() * (x.shape[0] if "['blocks']" in p
                                                                else 1)
                   for (p, s), x in leaves if p.endswith(f"['{name}']"))

    wo_term, w_out_term = product_term("wo"), product_term("w_out")
    assert model["all-reduce"] == grad_term + wo_term + w_out_term
    # the port's differences, by design
    attn_full = sum(x.numel() * x.element_size() for (p, s), x in leaves
                    if "['attn']" in p and "model" in names(s))
    embed = meta["embed"]
    embed_full = embed.numel() * embed.element_size()
    embed_over_data = shard_bytes(mesh, P("model", None), embed)
    want = {
        ("all-gather", "data", "forward"): model["all-gather"] // 2,
        ("all-gather", "data", "backward"): model["all-gather"] // 2 - embed_over_data,
        ("all-gather", "model", "forward"): attn_full + embed_full,
        ("all-gather", "model", "backward"): attn_full,
        ("reduce-scatter", "data.grad", "backward"): model["reduce-scatter"],
        ("all-reduce", "grad", "update"): grad_term,
        ("all-reduce", "mlp", "forward"): w_out_term // 2,
        ("all-reduce", "mlp.grad", "backward"): w_out_term // 2,
        ("all-reduce", "mlp", "backward"): w_out_term // 2,  # the recompute
        ("all-reduce", "loss", "update"): 4,
        ("all-reduce", "norm", "update"): 4,
    }
    for rank in port["gemma3-1b@4x2"]:
        assert rank["counts"] == want
        assert rank["staged_bytes"] == {}


def test_the_example_runs_in_process_on_cpu_ranks(tmp_path, capsys):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import torch_distributed_smoke as ex
    finally:
        sys.path.pop(0)
    assert ex.main(["--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "mesh: {'data': 4, 'model': 2} over 8 ranks; backend gloo, 8 CPU ranks"
    steps = [ln for ln in out if ln.startswith("  step ")]
    resumed = [ln for ln in out if ln.startswith("  [re-meshed 3x2] step ")]
    assert [ln.split(":")[0] for ln in steps] == [f"  step {s}" for s in range(6)]
    assert [ln.split(":")[0] for ln in resumed] == [f"  [re-meshed 3x2] step {s}"
                                                     for s in range(6, 9)]
    assert "elastic plan after 1 failed chip: data 4->3, batch/shard 2" in out
    assert "checkpointed at step 6" in out
    assert out[-1] == "resumed training on the degraded mesh — elastic restart OK"
    assert all(np.isfinite(float(ln.split("loss=")[1])) for ln in steps + resumed)


def test_the_example_refuses_to_run_without_a_gpu_unless_told_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import torch_distributed_smoke as ex
    finally:
        sys.path.pop(0)
    assert ex.main(["--ckpt-dir", str(tmp_path)]) == 2
    assert "pass --device cpu" in capsys.readouterr().err
