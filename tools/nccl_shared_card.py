"""Does NCCL take two ranks on one card?  The rank-mesh trainer's backend
rule (``repro_torch.launch.distributed.choose_backend``) says no and runs
ranks that share a card on gloo; this checks the premise on the machine
it runs on.

Two ranks, both on ``cuda:0``, join an ``nccl`` process group and
all-reduce one tensor.  Prints the card, and either the result or the
error the ranks raised (its first lines), then exits 0: the check records
what NCCL does, and nothing switches backend on its answer.

Run:  PYTHONPATH=src python tools/nccl_shared_card.py
"""
import subprocess
import sys

import torch

from repro_torch.launch.distributed import Backend, run_ranks

TIMEOUT_S = 90


def _all_reduce(device):
    import torch.distributed as dist

    x = torch.ones(4, device=device) * (dist.get_rank() + 1)
    dist.all_reduce(x)
    torch.cuda.synchronize(device)
    return x.tolist()


def main() -> int:
    if not torch.cuda.is_available():
        print("nccl_shared_card: no CUDA device is visible", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, NCCL {torch.cuda.nccl.version()}")
    shared = Backend("nccl", ("cuda:0", "cuda:0"), "nccl, 2 ranks on cuda:0")
    try:
        out = run_ranks(_all_reduce, (), shared, "build/nccl_shared_card_rendezvous", TIMEOUT_S)
        print(f"nccl took two ranks on one card: all-reduce gave {out}")
    except RuntimeError as e:
        lines = [ln for ln in str(e).splitlines() if ln.strip()]
        errors = [ln for ln in lines if "Error" in ln or "error" in ln]
        print("nccl refused two ranks on one card:")
        for ln in (errors or lines)[:6]:
            print(f"  {ln.strip()[:400]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
