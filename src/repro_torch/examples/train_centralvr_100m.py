"""End-to-end training driver — the port of the reference's
``examples/train_centralvr_100m.py``: a ~100M-param dense LM trained with
CentralVR for a few hundred steps through the full stack (config ->
data pipeline -> CentralVR train step -> checkpointing -> eval).

The default profile is the reference's container-sized one (a ~21M
model, 200 steps); ``--full`` selects the ~100M x 304-step profile.
The optimizer is Adam, so the run takes ``fused="auto"``: on an H100 the
model's forward runs the kernels (K2 RMSNorm, K3 flash attention) and
the VR step stays unfused (the fused VR step bakes a plain SGD update).
The default profile's head_dim 40 is no size K3 takes (32, 64, 128,
256): on the card the run refuses it by name when it is built; run
``--full`` (head_dim 64) there.

    python -m repro_torch.examples.train_centralvr_100m [--full] [--device cpu]
"""
import argparse

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.train import loop


def model_cfg(full: bool) -> ModelConfig:
    if full:
        # 94.1M params (param_count()): 12L, d=640, GQA 10/2, vocab 32k
        return ModelConfig(
            name="centralvr-100m", family="dense", num_layers=12,
            d_model=640, num_heads=10, num_kv_heads=2, head_dim=64,
            d_ff=1792, vocab_size=32000, qkv_bias=True,
            norm_type="rmsnorm", mlp_type="swiglu")
    # ~21M params: the same family, container-sized
    return ModelConfig(
        name="centralvr-20m", family="dense", num_layers=8, d_model=320,
        num_heads=8, num_kv_heads=2, head_dim=40, d_ff=896,
        vocab_size=16000, qkv_bias=True, norm_type="rmsnorm",
        mlp_type="swiglu")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--checkpoint", default="results/ckpt/centralvr_lm.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    cfg = model_cfg(args.full)
    # the epoch loop drives whole communication epochs (M*K = 8 steps
    # each), so the step budget is a multiple of 8
    steps = args.steps or (304 if args.full else 200)
    tcfg = TrainConfig(
        seq_len=256 if args.full else 128,
        global_batch=8, microbatch=2,
        learning_rate=3e-3, optimizer="adam",
        vr="centralvr", vr_table_size=8, local_epoch=1, seed=0)
    n_params = cfg.param_count()
    print(f"model: {cfg.name}  params={n_params / 1e6:.1f}M  "
          f"steps={steps}  vr={tcfg.vr} (M={tcfg.vr_table_size})")
    res = loop.run_training(
        cfg, tcfg, steps=steps, log_every=2,
        checkpoint_path=args.checkpoint, checkpoint_every=12,
        device=args.device, fused="auto")
    print(f"\ndone in {res.wall_time:.0f}s — "
          f"train loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}; "
          f"held-out eval loss {res.final_eval_loss:.3f}; "
          f"checkpoint at {args.checkpoint}")
    if not res.losses[-1] < res.losses[0]:
        raise SystemExit("training made no progress: the last loss is not "
                         "below the first")
    return dict(losses=res.losses, eval_loss=res.final_eval_loss,
                wall_s=res.wall_time, params=n_params)


if __name__ == "__main__":
    main()
