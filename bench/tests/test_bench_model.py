"""The model as a part of the cell: a configuration names its model module
(``bench/reference/<model>.py``, ``sd`` where it names none), and the
harness draws the conditioning, lays out the weights, counts the
operations and runs the reference through it.

The digests below were taken before the model became the configuration's
choice: the ``sd`` cells' weights, traffic and warm-up requests are drawn
as they were then.  A second model, ``sd`` plus a pooled prompt vector
added to the time embedding through one dense layer, runs in a toy root
with no harness file changed."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import types

import numpy as np
import pytest
import torch

from bench import check, flops, serve, spec
from bench.reference.weights import _Spec, make_weights
from bench.tests.conftest import ROOT, TOY_UNET, write_toy_root
from bench.traffic import Traffic

SD = spec.load_model("sd")
CFG14 = json.loads((ROOT / "bench" / "configs" / "sd_v14.json").read_text())
TIERS_MIX = json.loads((ROOT / "bench" / "mixes" / "tiers.backlog.json").read_text())


def _walk(tree, path=""):
    """(path, leaf) in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, tree


def _short(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def tree_digest(tree) -> str:
    h = hashlib.sha256()
    for path, leaf in _walk(tree):
        h.update(path.encode())
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def layout_digest(layout, cfg) -> str:
    """Every leaf's path, place in the draw, shape and scale."""
    s = _Spec()
    tree = layout(s, cfg)
    for i, (holder, key, *_) in enumerate(s.leaves):
        holder[key] = i
    rows = [[path, i, list(s.leaves[i][2]), s.leaves[i][3], s.leaves[i][4]]
            for path, i in _walk(tree)]
    return _short(json.dumps(rows).encode())


#: (seed, dtype) -> (U-Net, VAE) digests of the toy configuration's weights
WEIGHTS = {
    (11, "float32"): ("757cd0803a80700f", "cad34688f9a3d300"),
    (11, "bfloat16"): ("27528ee53337f305", "cad34688f9a3d300"),
    (2**31 + 3, "float32"): ("989633379afaf032", "6445e861657e9e54"),
    (2**31 + 3, "bfloat16"): ("a4e839c953d8c970", "6445e861657e9e54"),
}
#: sd_v14's layouts (too large to draw on the CPU): U-Net, VAE
LAYOUT_SD_V14 = ("aa853a97c47e15c7", "0682048a1d8e8850")
#: (configuration, seed) -> request index -> (tier, ctx digest, noise digest),
#: the tiers mix
TRAFFIC = {
    ("toy", 0): {0: ("balanced", "e15e87d0f2e18aa4", "730b761ca4ad7e00"),
                 5: ("draft", "c8f07aae7cbe656b", "8a27fa2c7679ca9c"),
                 17: ("high", "08cdb9d87eac0fda", "7e76538568ae72af")},
    ("toy", 2**31 + 17): {0: ("balanced", "4ea8de89397594b9", "e17b53787a80aa88"),
                          5: ("draft", "3b0d9bd67b4efea0", "a3ca7018f8c3e832"),
                          17: ("high", "9a397a987234e575", "0cf5b174760a0543")},
    ("toy", 2**33 + 5): {0: ("balanced", "ac71aa0e9a27016b", "72615c70b9784d86"),
                         5: ("draft", "279b3b7360ec449c", "feb81aa28c25f94d"),
                         17: ("high", "18c6562ffd034bf6", "6a84c3159b24f07c")},
    ("sd_v14", 0): {0: ("balanced", "53132cac5882800b", "bda74d3c881ef72d"),
                    5: ("draft", "1e678f65c440ca6d", "96c28ccf51a3d561"),
                    17: ("high", "f3b93351c9f66a38", "ad8707632e485f28")},
    ("sd_v14", 2**31 + 17): {0: ("balanced", "ee66498cfaf8c9fb", "05e91b2aa3a85997"),
                             5: ("draft", "251872c79dbf95c1", "07d15a6162afafd8"),
                             17: ("high", "cd548ec19fc4779b", "967312812883492e")},
    ("sd_v14", 2**33 + 5): {0: ("balanced", "4332bfbb6eb8be55", "ca14a0dad4915b16"),
                            5: ("draft", "0d335c05a2a30846", "9310d72a0d7a80f9"),
                            17: ("high", "0a0eac5b228f6404", "c3c60b607e9157b0")},
}
#: the toy configuration's three warm-up requests (ctx, then noise, each)
WARM_TOY = "a20eed9e5d31eebc"
#: operations of one CFG pair by class, and of one decode, at the toy
#: configuration (sd_v14's are ``test_bench_reference.EXPECTED``)
FLOPS_TOY = dict(FULL=569_081_856, SKETCH=296_452_096, REFINE=207_683_584, DECODE=252_575_744)
UNETS = {"toy": TOY_UNET, "sd_v14": CFG14["unet"]}


@pytest.mark.parametrize("seed, dtype", sorted(WEIGHTS))
def test_weights_are_drawn_as_before(seed, dtype):
    unet, vae = make_weights(dict(TOY_UNET, dtype=dtype), seed, "cpu", SD)
    assert (tree_digest(unet), tree_digest(vae)) == WEIGHTS[(seed, dtype)]


def test_sd_v14_layout_is_as_before():
    u = CFG14["unet"]
    assert (layout_digest(SD.unet_layout, u), layout_digest(SD.vae_layout, u)) == LAYOUT_SD_V14


@pytest.mark.parametrize("config, seed", sorted(TRAFFIC))
def test_traffic_is_drawn_as_before(config, seed):
    t = Traffic(TIERS_MIX, dict(CFG14, unet=UNETS[config]), seed, SD)
    for i, want in TRAFFIC[(config, seed)].items():
        r = t.request(i)
        assert set(r.cond) == {"ctx"}
        assert (r.tier, _short(r.cond["ctx"].tobytes()), _short(r.noise.tobytes())) == want


def test_warm_requests_are_drawn_as_before():
    P = types.SimpleNamespace(engine=types.SimpleNamespace(GenRequest=lambda **k: k))
    policy = types.SimpleNamespace(
        resolve=lambda steps, quality: types.SimpleNamespace(plan=(steps, quality)))
    reqs = serve.warm_requests(P, policy, dict(CFG14, unet=TOY_UNET), 3, SD)
    assert _short(b"".join(r["ctx"].tobytes() + r["noise"].tobytes() for r in reqs)) == WARM_TOY


def test_toy_class_flops_are_as_before():
    assert flops.class_flops(TOY_UNET, 3, 2, SD) == FLOPS_TOY
    assert flops.class_flops(TOY_UNET, 3, 2) == FLOPS_TOY  # no model: sd


def test_model_key_written_out_gives_the_same_cell(tmp_path):
    """``"model": "sd"`` in sd_v14.json reads as the file without the key."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = tmp_path / "bench" / "configs" / "sd_v14.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), model="sd")))
    for name in ("sd_v14.tiers.backlog", "sd_v14.exact.backlog"):
        a = spec.load_cell(name)
        b = spec.load_cell(name, tmp_path, tmp_path / "bench")
        assert "model" not in a.config and b.config.pop("model") == "sd"
        assert dataclasses.replace(b, model=a.model) == a
        assert b.model.__name__ == a.model.__name__ == "bench_model_sd"
        assert open(b.model.__file__).read() == open(a.model.__file__).read()


def test_unknown_model_fails_with_the_missing_path(tmp_path):
    root = write_toy_root(tmp_path)
    path = root / "bench" / "configs" / "toy.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), model="no_such_model")))
    with pytest.raises(FileNotFoundError, match=r"reference/no_such_model\.py"):
        spec.load_cell("toy.tiers.backlog", root, root / "bench")


# ---------------------------------------------------------------------------
# a second model, from new files alone
# ---------------------------------------------------------------------------

POOLED_DIM = 24
#: ``sd`` plus a pooled prompt vector [pooled_dim], drawn after ``ctx``,
#: added to the time embedding through one dense layer (no bias); its
#: unconditional half is zero, as ``sd``'s is
POOLED_MODEL = '''

# ---------------------------------------------------------------------------
# a pooled prompt vector added to the time embedding
# ---------------------------------------------------------------------------

_sd_conditioning, _sd_conditioning_shapes = conditioning, conditioning_shapes
_sd_unet_layout, _sd_time_embedding = unet_layout, time_embedding


def conditioning(cfg, rng):
    cond = _sd_conditioning(cfg, rng)
    cond["pooled"] = (rng.normal(size=(cfg["pooled_dim"],)) * 0.2).astype("float32")
    return cond


def conditioning_shapes(cfg):
    return dict(_sd_conditioning_shapes(cfg), pooled=(cfg["pooled_dim"],))


def unet_layout(s, cfg):
    p = _sd_unet_layout(s, cfg)
    p["add_pooled"] = {}
    s.dense(p["add_pooled"], "w", cfg["pooled_dim"], cfg["time_dim"])
    return p


def time_embedding(cfg, p, t, cond):
    return _sd_time_embedding(cfg, p, t, cond) + mm(cond["pooled"], p["add_pooled"]["w"])
'''
POOLED_CELL = "toy_pooled.tiers.backlog"


@pytest.fixture(scope="module")
def pooled_root(tmp_path_factory):
    """The toy root plus the model ``sd_pooled``, a configuration that
    names it and a cell of it: new files and entries only."""
    root = write_toy_root(tmp_path_factory.mktemp("pooled"))
    bench = root / "bench"
    (bench / "reference" / "sd_pooled.py").write_text(
        (ROOT / "bench" / "reference" / "sd.py").read_text() + POOLED_MODEL)
    cfg = json.loads((bench / "configs" / "toy.json").read_text())
    cfg.update(name="sd_toy_pooled", model="sd_pooled", unet=dict(TOY_UNET, pooled_dim=POOLED_DIM))
    (bench / "configs" / "toy_pooled.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "limits" / "toy.tiers.backlog.json",
                bench / "limits" / f"{POOLED_CELL}.json")
    bm = json.loads((root / "BENCHMARK.json").read_text())
    bm["configs"].append(dict(bm["configs"][0], name="toy_pooled",
                              file="bench/configs/toy_pooled.json"))
    bm["workloads"].append(dict(bm["workloads"][0], name=POOLED_CELL, config="toy_pooled"))
    (root / "BENCHMARK.json").write_text(json.dumps(bm))
    return root


@pytest.fixture(scope="module")
def pooled(pooled_root):
    return spec.load_cell(POOLED_CELL, pooled_root, pooled_root / "bench")


def test_second_model_is_the_cells(pooled):
    assert pooled.model.__name__ == "bench_model_sd_pooled"
    assert pooled.model.conditioning_shapes(pooled.config["unet"]) == {
        "ctx": (8, 32), "pooled": (POOLED_DIM,)}


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_second_model_traffic_draws_the_pooled_vector(pooled, seed):
    """The model's conditioning is drawn in its order: ``ctx`` first, as
    ``sd`` draws it, then ``pooled``, then the noise."""
    t = Traffic(pooled.mix, pooled.config, seed, pooled.model)
    plain = Traffic(pooled.mix, pooled.config, seed, SD)
    for i in (0, 5):
        r, again = t.request(i), Traffic(pooled.mix, pooled.config, seed, pooled.model).request(i)
        assert set(r.cond) == {"ctx", "pooled"} and r.cond["pooled"].shape == (POOLED_DIM,)
        assert r.cond["pooled"].dtype == np.float32
        assert np.array_equal(r.cond["ctx"], plain.request(i).cond["ctx"])
        assert all(np.array_equal(r.cond[k], again.cond[k]) for k in r.cond)
        assert np.array_equal(r.noise, again.noise)


def test_second_model_weights_have_its_extra_leaves(pooled):
    """The extra dense layer is drawn after every ``sd`` leaf, so those
    read as ``sd``'s from the same seed, but for the last one or two: the
    CPU's normal draw makes its last 16 values anew for another length."""
    u = pooled.config["unet"]
    mine, vae = make_weights(u, 7, "cpu", pooled.model)
    base, base_vae = make_weights(u, 7, "cpu", SD)
    w = mine.pop("add_pooled")["w"]
    assert w.shape == (POOLED_DIM, u["time_dim"])
    assert w.std().item() == pytest.approx(POOLED_DIM ** -0.5, rel=0.1)
    pairs = list(zip(_walk(mine), _walk(base)))
    assert len(pairs) == len(list(_walk(base))) and all(pa == pb for (pa, _), (pb, _) in pairs)
    assert [pa for (pa, a), (_, b) in pairs if not torch.equal(a, b)] == [
        "/conv_out/b", "/conv_out/w"]
    assert tree_digest(vae) != tree_digest(base_vae)  # drawn after a longer U-Net


def test_second_model_flops_count_the_extra_layer(pooled):
    u, e = pooled.config["unet"], pooled.config["engine"]
    mine = flops.class_flops(u, e["l_sketch"], e["l_refine"], pooled.model)
    base = flops.class_flops(u, e["l_sketch"], e["l_refine"], SD)
    per_sample = 2 * POOLED_DIM * u["time_dim"]
    assert {k: mine[k] - base[k] for k in base} == dict(
        FULL=2 * per_sample, SKETCH=2 * per_sample, REFINE=2 * per_sample, DECODE=0)


def test_second_model_reference_runs_on_the_cpu(pooled):
    """``check.reference_outputs`` runs the model on the CPU; the pooled
    vector reaches the U-Net (zero, the output is ``sd``'s, bitwise)."""
    seed = 2**31 + 17
    traffic = Traffic(pooled.mix, pooled.config, seed, pooled.model)
    rids = [0, 1]
    record = {"seed": seed, "requests": {i: {"tier": traffic.tier(i)} for i in rids}}
    refs = check.reference_outputs(pooled, record, rids, "cpu", "fp32", traffic)
    u, e = pooled.config["unet"], pooled.config["engine"]
    sampler = dict(pooled.config["sampler"])
    unet_w, _ = make_weights(u, seed, "cpu", pooled.model)
    sd_w, _ = make_weights(u, seed, "cpu", SD)
    sd_plus = dict(sd_w, add_pooled=unet_w["add_pooled"])
    for i in rids:
        lat, img = refs[i]
        assert lat.shape == (u["latent_size"] ** 2, 4) and img.shape == (16 * lat.shape[0], 3)
        assert np.all(np.isfinite(lat)) and np.all(np.isfinite(img))
        r = traffic.request(i)
        cond = {k: torch.from_numpy(v)[None] for k, v in r.cond.items()}
        noise = torch.from_numpy(r.noise)[None]
        run = lambda model, w, c: model.sample(  # noqa: E731
            u, sampler, w, noise, c, r.tier, l_sketch=e["l_sketch"], l_refine=e["l_refine"])[0]
        with torch.no_grad(), pooled.model.precision("fp32", torch.device("cpu")):
            assert np.array_equal(run(pooled.model, unet_w, cond).numpy(), lat)
            zero = dict(cond, pooled=torch.zeros_like(cond["pooled"]))
            plain = run(SD, sd_w, {"ctx": cond["ctx"]})
            assert torch.equal(run(pooled.model, sd_plus, zero), plain)
            assert not np.allclose(run(pooled.model, sd_plus, cond).numpy(), plain.numpy(),
                                   atol=1e-3)
