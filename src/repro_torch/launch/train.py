"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> [--preset tiny|100m|full] [--data N --model M] [...]`` (the
reference's ``repro/launch/train.py``, its flags and defaults, plus
``--device``).

Trains a reduced or full config with the distributed train step
(``training/trainer.py``) on the reference's synthetic data
(``training/data.py``), bf16 weights from seed 0, and checkpoints with
``--ckpt``.  Runs on ``cuda`` unless ``--device cpu`` is given.  ``--data N
--model M`` spawns N x M ranks (``launch/mesh.spawn``): one card a rank
over NCCL, or on the host over gloo under ``--device cpu``; rank 0
prints."""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, RuntimeConfig, afmoe_pattern, get_model_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.mesh import TPGroup, spawn
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.data import make_training_batch
from repro_torch.training.trainer import init_train_state, \
    make_train_step, param_leaves


def reduce_cfg(cfg: ModelConfig, preset: str) -> ModelConfig:
    """Shrink an arch to a trainable-on-CPU size, keeping its
    family/structure (copy of the reference's; an afmoe config, which the
    reference lacks, keeps 8 layers of its pattern's shape)."""
    if preset == "full":
        return cfg
    sizes = {"tiny": (2, 128, 512), "100m": (4, 512, 8192)}
    layers, d, vocab = sizes[preset]
    n_pat = len(cfg.block_pattern)
    kw = {}
    if cfg.family == "afmoe":
        # one kind a layer: 8 layers keep the dense lead (at most 2) and
        # two periods of the sliding/full cycle
        pat = cfg.block_pattern
        dense = sum(1 for k in pat[:2] if k.endswith("_mlp"))
        every = next((i + 1 for i, k in enumerate(pat) if "_full_" in k),
                     len(pat))
        layers = n_pat = 8
        kw["block_pattern"] = afmoe_pattern(
            tuple(i % every == every - 1 for i in range(8)), dense)
        kw["embed_scale"] = d ** 0.5 if cfg.embed_scale != 1.0 else 1.0
    layers = max(layers, n_pat)
    layers -= layers % n_pat
    heads = max(2, min(cfg.num_heads, d // 64))
    kv = max(1, min(cfg.num_kv_heads, heads))
    kw.update(num_layers=layers, d_model=d, num_heads=heads, num_kv_heads=kv,
              head_dim=0, d_ff=(d * 4 if cfg.d_ff else 0),
              vocab_size=min(cfg.vocab_size, vocab),
              encoder_layers=min(cfg.encoder_layers, layers),
              encoder_frames=min(cfg.encoder_frames, 64),
              num_patches=min(cfg.num_patches, 16))
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_ff_expert=d * 2,
            capacity_factor=2.0,
            shared_expert_d_ff=d if cfg.moe.shared_expert_d_ff else 0)
    if cfg.sliding_window:
        kw["sliding_window"] = 64
    return dataclasses.replace(cfg, **kw)


def train_rank(group: Optional[TPGroup], config: Config, steps: int,
               log_every: int, ckpt: Optional[str], preset: str,
               device=None) -> list:
    """One rank's run: init, ``steps`` train steps, the checkpoint.
    Returns the (step, loss, gnorm) log; rank 0 prints."""
    cfg, rt = config.model, config.runtime
    params, opt = init_train_state(config, 0, group, device=device)
    dev = params["embed"]["table"].device if "embed" in params else \
        params["decoder"]["embed"]["table"].device
    lead = group is None or (group.rank == 0 and group.dp_rank == 0)
    step_fn = make_train_step(config, group)
    ctx = step_fn.ctx
    if lead:
        # the whole tp-built model's elements: sharded leaves tp times
        n = sum(leaf.numel * (ctx.tp if leaf.sharded else 1)
                for leaf in param_leaves(params))
        print(f"arch={cfg.name} preset={preset} params="
              f"{n / 1e6:.1f}M mesh=({config.parallel.data}, "
              f"{config.parallel.model}) device={dev}", flush=True)
    log = []
    t_start = time.perf_counter()
    for step in range(steps):
        b = make_training_batch(cfg, rt.seq_len, rt.global_batch, step)
        loss, gnorm = step_fn(params, opt, b, step)
        if step % log_every == 0 or step == steps - 1:
            synchronize(dev)
            dt = time.perf_counter() - t_start
            tok_s = (step + 1) * rt.global_batch * rt.seq_len / dt
            log.append((step, float(loss), float(gnorm)))
            if lead:
                print(f"step {step:5d} loss {float(loss):.4f} "
                      f"gnorm {float(gnorm):.3f} tok/s {tok_s:,.0f}",
                      flush=True)
    if ckpt:
        full = ckpt_lib.gather_params(params, ctx)
        if lead:
            ckpt_lib.save(ckpt, {"params": full}, step=steps)
            print(f"checkpoint -> {ckpt}")
    return log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="100m",
                    choices=["tiny", "100m", "full"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--iso", action="store_true",
                    help="train with the ISO schedule (default: baseline)")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduce_cfg(get_model_config(args.arch), args.preset)
    parallel = ParallelConfig(data=args.data, model=args.model)
    rt = RuntimeConfig(mode="train_iso" if args.iso else "train",
                       seq_len=args.seq_len, global_batch=args.batch,
                       learning_rate=args.lr, max_steps=args.steps,
                       warmup_steps=max(10, args.steps // 20), remat=True)
    config = Config(model=cfg, parallel=parallel, runtime=rt,
                    iso=ISOConfig(num_chunks=2, min_chunk_tokens=32,
                                  chunk_align=16))
    opts = (args.steps, args.log_every, args.ckpt, args.preset)
    if args.data * args.model == 1:
        train_rank(None, config, *opts, device=device)
    else:
        spawn(train_rank, args.model, args=(config,) + opts,
              device=device.type, data=args.data)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
