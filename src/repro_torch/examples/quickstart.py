"""Quickstart: the paper's algorithm in both of its homes — the port of
the reference's ``examples/quickstart.py``.

1. Convex (paper-faithful): CentralVR vs SGD on l2-regularized logistic
   regression — linear convergence with a CONSTANT step size.
2. LM (framework): a tiny decoder trained with the CentralVR optimizer.

Both take the kernel path where it is compiled (``fused="auto"``): on an
H100, Algorithm 1's epochs are ``vr_epoch`` launches and the LM's steps
launch K1 (``vr_update``), K2 (``rmsnorm``) and K3
(``flash_attention``); on the CPU the unfused bodies run.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch.config import ConvexConfig, TrainConfig, get_arch
from repro_torch.core import baselines, centralvr, convex
from repro_torch.kernels import resolve_device
from repro_torch.train import loop


def convex_demo(device, epochs: int = 12):
    print("=== CentralVR on logistic regression (paper §6.1 toy) ===")
    cfg = ConvexConfig(problem="logistic", n=2000, d=20)
    prob = convex.make_problem(torch.Generator(device).manual_seed(0), cfg)
    _, rels_cvr, _ = centralvr.run(prob, eta=0.2, epochs=epochs, seed=1,
                                   fused="auto")
    _, rels_sgd = baselines.run_sgd(prob, eta=0.2, epochs=epochs, seed=1)
    rels_cvr, rels_sgd = rels_cvr.tolist(), rels_sgd.tolist()
    print(f"{'epoch':>6} {'CentralVR':>12} {'SGD':>12}")
    for e in range(0, epochs, 3):
        print(f"{e:6d} {rels_cvr[e]:12.2e} {rels_sgd[e]:12.2e}")
    print(f"final: CentralVR {rels_cvr[-1]:.2e} vs SGD {rels_sgd[-1]:.2e} "
          f"(same constant step, same gradient budget)\n")
    return rels_cvr, rels_sgd


def lm_demo(device, steps: int = 20):
    print("=== CentralVR as the optimizer of a tiny LM ===")
    cfg = get_arch("qwen2-7b").reduced()
    tcfg = TrainConfig(seq_len=64, global_batch=4, microbatch=2,
                       optimizer="sgd", learning_rate=0.2,
                       vr="centralvr", vr_table_size=4)
    res = loop.run_training(cfg, tcfg, steps=steps, log_every=5,
                            device=device, fused="auto")
    print(f"eval loss after {steps} steps: {res.final_eval_loss:.3f}\n")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "repro_torch.examples.quickstart")
    rels_cvr, rels_sgd = convex_demo(device)
    res = lm_demo(device)
    return dict(centralvr_rels=rels_cvr, sgd_rels=rels_sgd,
                losses=res.losses, eval_loss=res.final_eval_loss)


if __name__ == "__main__":
    main()
