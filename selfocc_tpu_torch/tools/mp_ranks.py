"""Each rank's peak memory, step seconds and collectives of the
model-parallel step (``train --mp``) for several rank counts, beside one
process's step, at ``nuscenes_occ``'s full width on synthetic item 0.

    python3 selfocc_tpu_torch/tools/mp_ranks.py [--ranks 2,4] \\
        [--backend gloo|nccl] [--steps 3] [OUT.json]

``--backend gloo`` (the default) puts every rank on card 0 (NCCL refuses
two ranks on one device), where ``gather_rows`` takes gloo's all-reduce
route; ``--backend nccl`` puts rank r on card r (as many cards as the
most ranks), the all-gather / reduce-scatter route. Each rank takes
``chip_smoke.SEED``'s weights (rank 0's broadcast), item 0 and the plain
step's generator: one step that builds the path, one with each
collective synchronised and timed (``chip_smoke.timed_collectives``),
then ``--steps`` steps, each ended by a synchronisation, whose peak
allocated memory is the rank's; at the end the ranks' parameters are
compared bit for bit. One process's step is timed first in the same way.
Prints the card's name and power limit and one JSON object, also written
to OUT (default ``work_dirs/mp_ranks.json``, git-ignored). Run from the
repository root on a machine with CUDA cards and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def trainer_and_batch(device, group=None):
    """``nuscenes_occ``'s seeded trainer (model-parallel over ``group``
    where given), synthetic item 0 on ``device`` and the generator of a
    step."""
    import torch
    import chip_smoke as cs
    from selfocc_tpu_torch.configs.experiments import get_config
    from selfocc_tpu_torch.train import build_trainer, step_seed
    from selfocc_tpu_torch.utils.runtime import get_dataset, to_device
    cfg = get_config("nuscenes_occ")
    trainer = build_trainer(cfg, cs.SEED, device, group=group,
                            model_parallel=group is not None)
    batch = to_device(get_dataset(cfg, synthetic=True, length=1)[0], device)

    def gen(step):
        return torch.Generator(device=device).manual_seed(
            step_seed(cs.SEED, step))
    return trainer, batch, gen


def timed_steps(trainer, batch, gen, steps, records=None):
    """A step that builds the path, with ``records`` one whose collectives
    are timed, then ``steps`` timed steps: (their times, peak GiB)."""
    import torch
    import chip_smoke as cs
    trainer.step(batch, gen(0), sync=torch.cuda.synchronize)
    if records is not None:
        restore = cs.timed_collectives(records)
        try:
            trainer.step(batch, gen(1), sync=torch.cuda.synchronize)
        finally:
            restore()
    return cs.dp_step_times(trainer, batch, lambda i: gen(i + 2), steps)


def rank_run(group, steps):
    """One spawned rank: ``timed_steps`` of the model-parallel step."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from selfocc_tpu_torch.parallel.mesh import broadcast_, replicas_equal
    trainer, batch, gen = trainer_and_batch(group.device, group)
    replicated = list(trainer.model.parameters()) + trainer.running_stats()
    broadcast_(replicated, group)
    records = []
    times, peak = timed_steps(trainer, batch, gen, steps, records)
    return {"steps": times, "peak_gb": peak, "route": trainer.shard.route,
            "rows": [r.count for r in trainer.shard.planes],
            "collectives": cs.collective_summary(records),
            "replicas_equal": replicas_equal(replicated, group)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?",
                    default=os.path.join(ROOT, "work_dirs", "mp_ranks.json"))
    ap.add_argument("--ranks", default="2,4")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("mp_ranks: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from selfocc_tpu_torch import _build
    from selfocc_tpu_torch.parallel.mesh import spawn
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    device = torch.device("cuda", 0)
    res = {"card": cs.card_name(), "backend": args.backend,
           "cards": torch.cuda.device_count()}
    trainer, batch, gen = trainer_and_batch(device)
    times, peak = timed_steps(trainer, batch, gen, args.steps)
    res["one_process"] = {"steps": times, "peak_gb": peak,
                          "step_s": cs.spread([t["step_s"] for t in times])}
    del trainer, batch
    torch.cuda.empty_cache()
    print(f"one process: step {res['one_process']['step_s']['median']:.3f}"
          f" s, peak {peak:.2f} GiB", flush=True)
    for world in (int(w) for w in args.ranks.split(",")):
        devices = [device] * world if args.backend == "gloo" else \
            [torch.device("cuda", r) for r in range(world)]
        ranks = spawn(rank_run, world, args.backend, devices,
                      args=(args.steps,))
        if not all(r["replicas_equal"] for r in ranks):
            raise AssertionError(f"{world} ranks not bit-equal")
        step_s = cs.spread([t["step_s"] for r in ranks for t in r["steps"]])
        res[f"ranks_{world}"] = {"step_s": step_s, "ranks": ranks}
        print(f"{world} ranks ({args.backend}, {ranks[0]['route']}): step "
              f"{step_s['median']:.3f} s ({step_s['min']:.3f}-"
              f"{step_s['max']:.3f}), peak GiB "
              f"{[round(r['peak_gb'], 2) for r in ranks]}, rows "
              f"{[r['rows'] for r in ranks]}", flush=True)
        for kind, c in ranks[0]["collectives"].items():
            print(f"  rank 0, {kind}: {c['calls']} calls, "
                  f"{c['ms']['median']:.1f} ms each, {c['ms_sum']:.1f} ms "
                  f"and {c['bytes_sum'] / 2**20:.1f} MiB a step", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f)
    print(res["card"], flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
