"""Training on a mesh of ranks, with a checkpoint and an elastic re-mesh:
the twin of ``examples/distributed_smoke.py``.

Eight ranks, one a position of a (4 data x 2 model) mesh, train gemma3-1b
SMOKE for 6 steps, each holding its shards of the parameters and AdamW
state as ``lm_pspecs`` / ``opt_pspecs`` place them (FSDP over "data", the
MLP tensor-parallel over "model"); the gathered state is checkpointed at
step 6.  Then one rank is taken as lost: ``ElasticPlan`` drops its data
row, and a fresh world of 6 ranks restores the checkpoint onto a 3 x 2
mesh and trains 3 more steps on the plan's 6-row batches.  (The
reference feeds its 8-row batches to the 3-way axis, which its pjit
refuses: 8 rows do not divide over 3 shards.)

The ranks start here (``torch.multiprocessing`` spawn, rendezvous on a
``FileStore`` in the checkpoint directory) and run on the card: ``nccl``
with a card a rank, else gloo with the collectives staged through host
memory; ``--device cpu`` runs gloo ranks on the CPU.  Weights are the
port's init from seed 0, not the reference's.

Run:  PYTHONPATH=src python examples/torch_distributed_smoke.py [--device cpu] [--ckpt-dir DIR]
"""
import argparse
import os
import sys

from repro_torch.common.sharding import spec_leaves
from repro_torch.configs import get_lm_config
from repro_torch.launch import distributed as D
from repro_torch.launch.steps import get_adapter
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.fault_tolerance import ElasticPlan

ARCH = "gemma3-1b"
MESH = (4, 2)
GLOBAL_BATCH = 8
STEPS = 6
RESUMED_STEPS = 3
OPT = AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=2)
DEFAULT_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "build",
                            "torch_dist_ckpt")


def _world(device: str, data: int, model: int) -> D.Backend:
    backend = D.choose_backend(device, data * model)
    print(f"mesh: {{'data': {data}, 'model': {model}}} over {data * model} ranks; "
          f"backend {backend.describe}")
    return backend


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT)
    args = ap.parse_args(argv)
    rendezvous = os.path.join(args.ckpt_dir, "rendezvous")
    try:
        backend = _world(args.device, *MESH)
    except RuntimeError as e:
        print(f"torch_distributed_smoke: {e}", file=sys.stderr)
        return 2

    specs = get_adapter(get_lm_config(ARCH, "smoke")).pspecs(MESH[1])
    print(f"params: {D.n_params(ARCH) / 1e6:.1f}M; leaf0 sharding: {spec_leaves(specs)[0]}")
    job = D.MeshJob(ARCH, MESH, (0, STEPS), GLOBAL_BATCH, opt=OPT, save=args.ckpt_dir)
    first = D.run_ranks(D.train_on_mesh, ([job],), backend, rendezvous)[0][0]
    for s, loss in enumerate(first["losses"]):
        print(f"  step {s}: loss={loss:.4f}")
    print(f"checkpointed at step {STEPS}")

    # --- simulated failure: lose 1 rank -> elastic re-mesh to 3x2 ----------
    plan = ElasticPlan.plan(data=MESH[0], model=MESH[1], failed=1, global_batch=GLOBAL_BATCH)
    print(f"elastic plan after 1 failed chip: data {plan.old_data}->{plan.new_data}, "
          f"batch/shard {plan.batch_per_data_shard}")
    backend = _world(args.device, plan.new_data, plan.new_model)
    job = D.MeshJob(ARCH, (plan.new_data, plan.new_model), (STEPS, STEPS + RESUMED_STEPS),
                    plan.new_global_batch, opt=OPT, restore=args.ckpt_dir)
    resumed = D.run_ranks(D.train_on_mesh, ([job],), backend, rendezvous)[0][0]
    for s, loss in enumerate(resumed["losses"], start=STEPS):
        print(f"  [re-meshed {plan.new_data}x{plan.new_model}] step {s}: loss={loss:.4f}")
    print("resumed training on the degraded mesh — elastic restart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
