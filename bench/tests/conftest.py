"""Fixtures of the benchmark's own tests: a toy benchmark root on the CPU.

The toy cells run the served path at the port's ``sd_toy`` sizes (a CPU
U-Net of 1.8 M parameters), 8 sampling steps and 2 lanes, through the same
harness functions a run on the card uses, with the plain ``eager`` backend.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TOY_UNET = dict(in_channels=4, out_channels=4, base_channels=32, channel_mult=[1, 2, 4],
                n_res_blocks=1, attn_levels=[0, 1], n_heads=2, tf_depth=1, ctx_dim=32,
                ctx_len=8, time_dim=128, groups=8, latent_size=16, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the open-loop toy cell: the tiers mix at Poisson arrivals (no cell of
#: the benchmark is open-loop yet; the generator and the harness are)
TOY_OPEN_LOOP = {"name": "toy.tiers.p80", "traffic": "tiers.p80", "from": "tiers.backlog",
                 "limits": "sd_v14.tiers.backlog"}


def write_toy_root(root: Path) -> Path:
    """A benchmark root at ``root`` whose cells are the real ones' mixes
    and limits over the toy configuration (steps 8, 2 lanes), plus an
    open-loop cell; its metric readers and model modules are copies of
    the real ones."""
    bench = root / "bench"
    for d in ("configs", "mixes", "limits"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "reference"):
        shutil.copytree(ROOT / "bench" / d, bench / d, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((ROOT / "bench" / "configs" / "sd_v14.json").read_text())
    cfg.update(name="sd_toy", unet=TOY_UNET)
    cfg["sampler"]["steps"] = 8
    cfg["engine"].update(n_lanes=2)
    (bench / "configs" / "toy.json").write_text(json.dumps(cfg))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = []
    for w in spec["workloads"]:
        mix = json.loads((ROOT / "bench" / "mixes" / f"{w['traffic']}.json").read_text())
        mix["steps"] = 8
        mix["arrivals"].update(queued=2, stagger_steps=3)
        (bench / "mixes" / f"{w['traffic']}.json").write_text(json.dumps(mix))
        name = "toy." + w["traffic"]
        shutil.copy(ROOT / "bench" / "limits" / f"{w['name']}.json",
                    bench / "limits" / f"{name}.json")
        cells.append(dict(w, name=name, config="toy"))
    o = TOY_OPEN_LOOP
    mix = json.loads((ROOT / "bench" / "mixes" / f"{o['from']}.json").read_text())
    mix.update(steps=8, arrivals={"kind": "poisson", "rate_per_s": 4.0},
               window={"after_s": 1.0, "drain_s": 30})
    (bench / "mixes" / f"{o['traffic']}.json").write_text(json.dumps(mix))
    shutil.copy(ROOT / "bench" / "limits" / f"{o['limits']}.json",
                bench / "limits" / f"{o['name']}.json")
    cells.append(dict(cells[0], name=o["name"], traffic=o["traffic"]))
    names = {w["name"]: "toy." + w["traffic"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [names[c] for c in m["workloads"]]
    spec.update(workloads=cells, configs=[dict(spec["configs"][0], name="toy",
                                              file="bench/configs/toy.json")])
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory) -> Path:
    return write_toy_root(tmp_path_factory.mktemp("toy"))
