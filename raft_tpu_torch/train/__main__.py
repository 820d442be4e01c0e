"""Train RAFT with the port (C -> T -> S/K/H schedule, one stage a run).

    python -m raft_tpu_torch.train --stage chairs --data-root /data/FlyingChairs \\
        --checkpoint-dir ckpts/chairs
    python -m raft_tpu_torch.train --stage sintel --data-root /data \\
        --init-from ckpts/things/best.pt --checkpoint-dir ckpts/sintel
    python -m raft_tpu_torch.train ... --device cpu   # no card

    python -m raft_tpu_torch.train ... --corr-impl fused --corr-dtype bfloat16 \
        --remat --remat-policy dots --window-size 2  # K1 in the step

The arguments are the JAX package's ``scripts/train.py``'s;
``--profile-port`` raises (PyTorch has no profiler server: profile
in-process with ``torch.profiler``), and ``--corr-impl pallas|onthefly``
does not train (K3 defines no gradient; the on-the-fly block is not
ported). ``--init-from`` and
``--export`` take the port's weight files (``--init-from`` also a Flax
``.msgpack``).
"""

from __future__ import annotations

import argparse
import os
import sys

# RAFT-recipe sampling weights for the S/K/H fine-tune mix (integer
# repeats, the original RAFT 'C+T+K+S+H' stage): 100x Sintel-clean + 100x
# Sintel-final + 200x KITTI + 5x HD1K + 1x Things.
SKH_WEIGHTS = {"sintel_clean": 100, "sintel_final": 100, "kitti": 200, "hd1k": 5, "things": 1}


def _find_root(root, *names):
    for name in names:
        cand = os.path.join(root, name)
        if os.path.isdir(cand):
            return cand
    return None


def build_dataset(stage: str, root: str):
    """The training dataset of a stage under ``root``."""
    from raft_tpu_torch.data import HD1K, ConcatDataset, FlyingChairs, FlyingThings3D, Kitti, RepeatDataset, Sintel

    if stage == "chairs":
        return FlyingChairs(root, split="train")
    if stage == "things":
        return FlyingThings3D(root)
    if stage == "kitti":
        return Kitti(root)
    if stage == "sintel":
        # the S/K/H mix: `root` holds the per-dataset roots (Sintel/
        # required; FlyingThings3D/, KITTI/, HD1K/ join when present)
        sintel_root = _find_root(root, "Sintel", "MPI-Sintel") or root
        parts = [
            RepeatDataset(Sintel(sintel_root, dstype="clean"), SKH_WEIGHTS["sintel_clean"]),
            RepeatDataset(Sintel(sintel_root, dstype="final"), SKH_WEIGHTS["sintel_final"]),
        ]
        things_root = _find_root(root, "FlyingThings3D", "flyingthings3d")
        if things_root:
            parts.append(FlyingThings3D(things_root, dstype="frames_cleanpass"))
        kitti_root = _find_root(root, "KITTI", "kitti", "KITTI-2015")
        if kitti_root:
            parts.append(RepeatDataset(Kitti(kitti_root), SKH_WEIGHTS["kitti"]))
        hd1k_root = _find_root(root, "HD1K", "hd1k")
        if hd1k_root:
            parts.append(RepeatDataset(HD1K(hd1k_root), SKH_WEIGHTS["hd1k"]))
        missing = [n for n, r in [("FlyingThings3D", things_root), ("KITTI", kitti_root), ("HD1K", hd1k_root)]
                   if r is None]
        if missing:
            print(f"S/K/H mix: {', '.join(missing)} not found under {root}; training on the remaining datasets")
        return ConcatDataset(parts)
    raise ValueError(f"unknown stage {stage}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--stage", required=True, choices=["chairs", "things", "sintel", "kitti"])
    p.add_argument("--data-root", required=True)
    p.add_argument("--arch", default="raft_large", choices=["raft_large", "raft_small"])
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--log-dir", default=None, help="write JSONL scalars here")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--profile-port", type=int, default=None, help="refused: PyTorch has no profiler server")
    p.add_argument("--init-from", default=None, help="weights to start from (.pt/.pth or Flax .msgpack)")
    p.add_argument("--corr-impl", default="dense", choices=["dense", "onthefly", "pallas", "fused"],
                   help="'dense', or 'fused' (K1 runs the lookup + convcorr1 forward, the dense "
                        "formulation's autograd the backward); 'pallas' and 'onthefly' raise")
    p.add_argument("--corr-dtype", default=None, choices=["bfloat16"])
    p.add_argument("--compute-dtype", default=None, choices=["bfloat16"])
    p.add_argument("--remat", action="store_true", help="recompute each refinement step in the backward")
    p.add_argument("--remat-policy", default=None, choices=["dots", "dots_no_batch", "corr"],
                   help="selective rematerialization under --remat: 'dots' keeps every convolution's and "
                        "matmul's output, 'dots_no_batch' the matmuls' without batch dimensions, 'corr' the "
                        "correlation features alone (convcorr1's output); the rest of each step is recomputed")
    p.add_argument("--window-size", type=int, default=1,
                   help="train steps a dispatch: the steps of a stacked batch window run back to back, their "
                        "metrics stay on the device until the log boundary's one fetch; --log-every, "
                        "--eval-every, --steps and the checkpoint interval must be multiples of it")
    p.add_argument("--check-numerics", action="store_true")
    p.add_argument("--export", default=None, help="write the final weights (torch state_dict) here")
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--eval-root", default=None)
    p.add_argument("--eval-dataset", default="sintel-clean", choices=["sintel-clean", "sintel-final", "kitti"])
    p.add_argument("--eval-iters", type=int, default=32)
    p.add_argument("--data-fault-policy", default="skip", choices=["skip", "raise"])
    p.add_argument("--data-bad-sample-budget", type=int, default=64)
    p.add_argument("--eval-fault-policy", default="skip", choices=["skip", "raise"])
    p.add_argument("--watchdog-timeout", type=float, default=None,
                   help="seconds a blocking region of the loop may stall before StallError (stacks to "
                        "<log-dir>/stall_stacks.log)")
    p.add_argument("--numerics-policy", default="raise", choices=["raise", "skip"])
    p.add_argument("--spike-factor", type=float, default=20.0)
    p.add_argument("--skip-budget", type=int, default=5)
    p.add_argument("--max-rollbacks", type=int, default=3)
    p.add_argument("--rollback-lr-scale", type=float, default=1.0)
    args = p.parse_args(argv)
    if args.remat_policy and not args.remat:
        p.error("--remat-policy requires --remat")

    import torch

    from raft_tpu_torch.train.trainer import STAGES, TrainConfig, Trainer

    stage = STAGES[args.stage]
    config = TrainConfig(
        arch=args.arch, stage=args.stage,
        num_steps=args.steps or stage["num_steps"],
        global_batch_size=args.batch_size or stage["global_batch_size"],
        learning_rate=args.lr or stage["learning_rate"],
        num_flow_updates=args.iters or stage["num_flow_updates"],
        crop_size=stage["crop_size"], seed=args.seed,
        checkpoint_dir=args.checkpoint_dir, log_dir=args.log_dir, log_every=args.log_every,
        profile_port=args.profile_port, corr_impl=args.corr_impl, corr_dtype=args.corr_dtype,
        compute_dtype=args.compute_dtype, remat=args.remat, remat_policy=args.remat_policy,
        window_size=args.window_size, check_numerics=args.check_numerics,
        eval_every=args.eval_every, eval_num_flow_updates=args.eval_iters,
        data_fault_policy=args.data_fault_policy, data_bad_sample_budget=args.data_bad_sample_budget,
        eval_fault_policy=args.eval_fault_policy, watchdog_timeout=args.watchdog_timeout,
        numerics_policy=args.numerics_policy, spike_factor=args.spike_factor,
        skip_budget=args.skip_budget, max_rollbacks=args.max_rollbacks,
        rollback_lr_scale=args.rollback_lr_scale, device=args.device,
    )
    eval_dataset = None
    if args.eval_every:
        if not args.eval_root:
            p.error("--eval-every requires --eval-root")
        from raft_tpu_torch.data import Kitti, Sintel

        if args.eval_dataset == "kitti":
            eval_dataset = Kitti(args.eval_root)
        else:
            eval_dataset = Sintel(args.eval_root, split="training", dstype=args.eval_dataset.split("-")[1])

    dataset = build_dataset(args.stage, args.data_root)
    if len(dataset) == 0:
        p.error(f"no samples found for stage {args.stage!r} under {args.data_root!r}: check the layout "
                "(e.g. FlyingChairs expects <root>/data/NNNNN_{img1,img2}.ppm + _flow.flo)")
    print(f"stage={args.stage} dataset={len(dataset)} pairs, {config}")
    init_from = None
    if args.init_from:
        from raft_tpu_torch.models.zoo import load_checkpoint

        init_from = load_checkpoint(args.init_from)
    trainer = Trainer(config, dataset, init_from=init_from, eval_dataset=eval_dataset)
    state = trainer.run()
    if args.export:
        torch.save({k: v.detach().cpu() for k, v in state.model.state_dict().items()}, args.export)
        print(f"wrote {args.export}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
