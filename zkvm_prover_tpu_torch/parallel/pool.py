"""Task-level proving parallelism (the reference's `parallel/pool.py`):
independent tasks (chunks, sibling proofs) proved by a process pool.

Each worker is a spawned OS process with its own prover stack, so
independent proofs never serialise on the GIL or on one host thread. The
parent has usually initialised CUDA already, so workers are spawned, never
forked. Tasks and proofs cross the process boundary as the host API's JSON
envelopes, the wire format of the disk cache and the release assets.

Devices: `device=None` (or "cuda") means the card; worker k pins
`cuda:{k % torch.cuda.device_count()}`, so on one H100 every worker shares
`cuda:0`. "cuda:i" pins every worker to card i; "cpu" keeps the workers on
the host. A worker that finds no card raises; none falls back to the CPU.
The pool sets no memory cap, as the reference sets none: on one H100 80GB,
two workers that each prove an in-circuit batch fit (its peak is
34,421,808,640 bytes), three do not.

The kernels' launch counters (`ops/*.launches`) are per process: a leaf
worker of `recursion/aggregation.py` sends back its own launches and C
calls with each proof.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..host.proof_types import StarkProof
from ..host.task import ProvingTask

_WORKER = {"device": None, "rank": None}


def pool_device(device) -> str:
    """The parent's device spec for its workers: "cuda" (pinned by rank),
    "cuda:i" or "cpu". None means the card and raises without one."""
    import torch

    spec = "cuda" if device is None else str(device)
    if spec.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to prove on the host")
        from .. import _build

        _build.build()   # compiled once here; each worker only loads it
    return spec


def spawn_pool(max_workers: int, device: str) -> ProcessPoolExecutor:
    """A spawn pool whose workers pin their devices (`worker_init`)."""
    ctx = mp.get_context("spawn")
    counter = ctx.Value("i", 0)
    return ProcessPoolExecutor(max_workers=max_workers, mp_context=ctx,
                               initializer=worker_init,
                               initargs=(device, counter, max_workers))


def worker_init(device: str, counter, n_workers: int = 1) -> None:
    """Runs once per worker: takes the next rank and pins the device. A
    host worker takes its share of the cores for torch's threads (workers
    that each spin on every core run many times slower)."""
    import torch

    with counter.get_lock():
        rank = counter.value
        counter.value += 1
    _WORKER["rank"] = rank
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"pool worker {rank}: no CUDA device")
        idx = rank % torch.cuda.device_count()
        torch.cuda.set_device(idx)
        device = f"cuda:{idx}"
    elif device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_workers))
    _WORKER["device"] = device


def worker_device() -> Optional[str]:
    """The device this worker pinned (None outside a pool worker)."""
    return _WORKER["device"]


def stark_config_dict(stark) -> dict:
    return {"fri": dataclasses.asdict(stark.fri), "coset_shift": stark.coset_shift}


def stark_config_from(d: dict):
    from ..stark.config import StarkConfig
    from ..stark.fri import FriConfig

    return StarkConfig(fri=FriConfig(**d["fri"]), coset_shift=d["coset_shift"])


def _prove_one(args) -> dict:
    """Worker entry: (app_name, task_json, config) -> proof dict."""
    app_name, task_json, cfg = args
    from ..host.prover import Prover, ProverConfig

    prover = Prover.setup(ProverConfig(
        app_name=app_name, stark=stark_config_from(cfg),
        child_verification=cfg["child_verification"], device=worker_device()))
    task = ProvingTask.from_dict(json.loads(task_json))
    return prover.gen_proof_stark(task).to_dict()


@dataclass
class ProvingPool:
    """Parallel prover over independent tasks (chunk-level parallelism).

    with ProvingPool(max_workers=2) as pool:
        proofs = pool.prove_all("chunk", tasks, stark_config)
    """

    max_workers: int = 2
    device: Optional[str] = None

    def __enter__(self) -> "ProvingPool":
        self._exec = spawn_pool(self.max_workers, pool_device(self.device))
        return self

    def __exit__(self, *exc) -> None:
        self._exec.shutdown(wait=True)

    def prove_all(self, app_name: str, tasks: Sequence[ProvingTask],
                  stark, child_verification: str = "in-circuit",
                  ) -> List[StarkProof]:
        cfg = dict(stark_config_dict(stark), child_verification=child_verification)
        payloads = [(app_name, json.dumps(t.to_dict()), cfg) for t in tasks]
        return [StarkProof.from_dict(d) for d in self._exec.map(_prove_one, payloads)]
