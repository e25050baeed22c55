"""End-to-end training on the PyTorch port: a ~100M-param dense LM for
a few hundred steps with checkpoint/restart, through the full launcher
path (``examples/train_lm.py`` on ``repro_torch``).  On the card every
forward runs the attention kernel; ``--device cpu`` runs its plain
version.  A checkpoint is written every 100 steps (every ``--steps``
steps when fewer); a second run with the same ``--ckpt-dir`` resumes from
the latest one.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
(~100M params is CPU-heavy; --tiny uses the smoke config for quick runs)
"""
import argparse

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention
from repro_torch.models.transformer import init_lm
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import leaves

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--tiny", action="store_true")
ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()

if args.tiny:
    cfg = reduced(get_config("tinyllama-1.1b"), num_layers=2, d_model=128,
                  vocab_size=512, d_ff=256)
    batch, seq = 8, 128
else:
    # ~100M-param llama-style config
    cfg = ModelConfig(name="lm-100m", family="dense", num_layers=12,
                      d_model=768, num_heads=12, num_kv_heads=12,
                      d_ff=2048, vocab_size=32000, act="silu",
                      norm="rmsnorm")
    batch, seq = 8, 512

device = resolve_device(args.device)
params = init_lm(cfg, 0, device=device)
n_params = sum(x.numel() for x in leaves(params))
print(f"model {cfg.name}: {n_params/1e6:.1f}M params")
opt_cfg = OptimizerConfig(lr=3e-4, warmup_steps=30, total_steps=args.steps)
data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
step = make_train_step(cfg, opt_cfg)
flash_attention.launches = 0
report = run_training(cfg, step, params, opt_cfg, data_cfg,
                      LoopConfig(total_steps=args.steps,
                                 ckpt_every=min(100, args.steps),
                                 ckpt_dir=args.ckpt_dir, log_every=10))
losses = report.losses or [float("nan")]
print(f"finished {report.steps_run} steps; "
      f"loss {losses[0]:.3f} -> {report.final_loss:.3f}; "
      f"resumed_from={report.resumed_from}")
print(f"attention kernel launches: {flash_attention.launches} on "
      f"{device.type}")
