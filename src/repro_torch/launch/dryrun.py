"""Production-mesh dry run: trace every (architecture x input shape x mesh)
on one rank's program with no devices, and report its collectives, its
costs and the roofline terms (port of ``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--iso-off]

The reference lowers and compiles each cell for 512 placeholder XLA
devices and parses the HLO.  The port runs ONE rank's program (rank 0 of
the 16 x 16 or 2 x 16 x 16 grid) on ``meta`` tensors, under
``core/analysis.Tracer``: weights (this rank's shard), caches, batch (this
data rank's rows) and optimizer state are shapes without data, and the
TP and data-parallel groups are process groups of PyTorch's ``"fake"``
backend, so the port's real ``psum_start``/``psum_wait`` and gradient
reduces run unchanged and show up as ``c10d`` ops.  The int8 reduce's
wrappers take their plain versions on meta tensors, for shapes only.  The
port traces every layer as it runs, so it needs none of the reference's
two-point extrapolation (XLA's cost analysis counts a while-loop body
once; the port has no loops to fold).  How the counts differ from XLA's
``cost_analysis`` and ``memory_analysis``: see ``core/analysis.py``;
``memory.code_bytes`` is 0 (nothing is compiled).

ISO on and off, as the reference: ISO applies to prefill only.  A
prefill cell with ISO on splits into ISO chunks; a decode cell runs
``runner.make_decode_fn``'s sequential schedule and a train cell the
step's plain forward (the runtime mode is never ``"train_iso"``), so a
decode or train cell is the same program with and without ``--iso-off``:
the same collectives, wire bytes and ``hideable_fraction``.

A default process group is created for the trace and destroyed after it;
the dry run refuses to start where one exists (run it in its own process).
An install without the ``"fake"`` backend raises and says so.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import Config, INPUT_SHAPES, ISOConfig, ModelConfig, \
    ParallelConfig, RuntimeConfig, get_model_config
from repro_torch.core.analysis import Trace, overlap_metric, \
    parse_collectives, trace_program
from repro_torch.launch import runner
from repro_torch.launch.mesh import TPGroup
from repro_torch.models import api
from repro_torch.perf.roofline import roofline_terms

# archs whose full-attention flavour cannot run 500k-token decode; dense
# archs get a sliding-window variant instead
LONG_SKIP = {"whisper-medium", "internvl2-2b"}
LONG_WINDOW = 8192
META = torch.device("meta")


def variant_for_shape(cfg: ModelConfig, shape_name: str
                      ) -> Optional[ModelConfig]:
    if shape_name == "long_500k":
        if cfg.name in LONG_SKIP:
            return None
        if cfg.family in ("dense", "moe", "vlm") and not cfg.sliding_window:
            return dataclasses.replace(cfg, sliding_window=LONG_WINDOW)
    return cfg


def production_parallel(multi_pod: bool = False) -> ParallelConfig:
    """The reference's production meshes: 16 x 16, or 2 x 16 x 16."""
    return ParallelConfig(data=16, model=16, pods=2 if multi_pod else 1)


def build_config(cfg: ModelConfig, parallel: ParallelConfig,
                 iso_on: bool = True, quantized: bool = False,
                 num_chunks: int = 2, policy: str = "even",
                 seq_parallel: bool = False, grad_int8: bool = False,
                 zero1: bool = False) -> Config:
    parallel = dataclasses.replace(parallel, seq_parallel=seq_parallel)
    iso = ISOConfig(enabled=iso_on, num_chunks=num_chunks,
                    split_policy=policy, quantized_comm=quantized)
    return Config(model=cfg, parallel=parallel, iso=iso,
                  runtime=RuntimeConfig(grad_comm_int8=grad_int8,
                                        zero1=zero1))


@contextlib.contextmanager
def fake_world(parallel: ParallelConfig):
    """Rank 0 of the ``pods x data x model`` grid on the ``"fake"``
    backend: yields its ``TPGroup`` on ``meta`` (the TP group of ranks
    0..model-1, the data-parallel group of every model-th rank), and
    destroys the default group on exit."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run needs PyTorch's 'fake' process-group "
                           "backend (torch.testing._internal.distributed."
                           "fake_pg), which this install lacks") from e
    if "fake" not in dist.Backend.backend_list:
        raise RuntimeError("the dry run needs PyTorch's 'fake' process-group "
                           "backend, which this install does not register")
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; run the "
                           "dry run in its own process")
    tp, dp = parallel.model, parallel.pods * parallel.data
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=tp * dp)
    try:
        group = TPGroup(rank=0, tp=tp, device=META, backend="fake",
                        group=dist.new_group(list(range(tp))), dp=dp,
                        dp_rank=0,
                        dp_group=dist.new_group(list(range(0, tp * dp, tp)))
                        if dp > 1 else None)
        yield group
    finally:
        dist.destroy_process_group()


def _bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


def _program(config: Config, group: TPGroup, shape):
    """(fn, its arguments): this rank's bf16 program of ``shape``'s kind."""
    cfg, tp, dtype = config.model, group.tp, torch.bfloat16
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        from repro_torch.training.trainer import init_train_state, \
            make_train_step
        params, opt = init_train_state(config, 0, group, dtype, META)
        batch = api.make_inputs(cfg, S, B, dtype=dtype, device=META)
        batch["labels"] = torch.empty(batch["tokens"].shape,
                                      dtype=torch.int32, device=META)
        return make_train_step(config, group), (params, opt, batch, 0)
    params = api.init_params(0, cfg, tp=tp, dtype=dtype, device=META,
                             rank=group.rank)
    if shape.kind == "prefill":
        batch = api.make_inputs(cfg, S, B, dtype=dtype, device=META)
        fn = runner.make_prefill_fn(config, group, logits_mode="last",
                                    return_cache=True, cache_len=S,
                                    global_batch=B)
        return fn, (params, batch)
    local_b = B // group.dp if runner._b_axes(config, B) else B
    caches = api.init_caches(cfg, local_b, S, tp, dtype=dtype, device=META,
                             local=True)
    fn = runner.make_decode_fn(config, group, global_batch=B)
    toks = torch.empty((B, 1), dtype=torch.int32, device=META)
    lens = torch.empty((B,), dtype=torch.int32, device=META)
    return fn, (params, toks, caches, lens)


def trace_shape(arch: str, shape_name: str, *, multi_pod: bool = False,
                iso_on: bool = True, quantized: bool = False,
                num_chunks: int = 2, policy: str = "even",
                blockwise_attn: bool = False, grad_int8: bool = False,
                zero1: bool = False, verbose: bool = True,
                cfg: Optional[ModelConfig] = None,
                parallel: Optional[ParallelConfig] = None
                ) -> Optional[Tuple[Dict[str, Any], Trace]]:
    """``lower_shape``'s report and the trace it was read from.  ``cfg``
    and ``parallel`` stand in for the registry's config of ``arch`` and the
    production mesh (the tests' small cells)."""
    base_cfg = cfg if cfg is not None else get_model_config(arch)
    shape = INPUT_SHAPES[shape_name]
    cfg = variant_for_shape(base_cfg, shape_name)
    if cfg is None:
        if verbose:
            print(f"SKIP {arch} x {shape_name} (no 500k-token variant)")
        return None
    if blockwise_attn:
        cfg = dataclasses.replace(cfg, attn_impl="blockwise")
    custom = parallel is not None
    parallel = parallel or production_parallel(multi_pod)
    config = build_config(cfg, parallel, iso_on=iso_on, quantized=quantized,
                          num_chunks=num_chunks, policy=policy,
                          grad_int8=grad_int8, zero1=zero1)
    t0 = time.perf_counter()
    with fake_world(parallel) as group:
        fn, args = _program(config, group, shape)
        args_bytes = _bytes(args)
        out, trace = trace_program(fn, *args)
        out_bytes = _bytes(out)
        del fn, args, out
    t_trace = time.perf_counter() - t0

    coll = parse_collectives(trace)
    mesh = f"{parallel.pods}x{parallel.data}x{parallel.model}" \
        if parallel.pods > 1 else f"{parallel.data}x{parallel.model}"
    report: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": mesh if custom else ("2x16x16" if multi_pod else "16x16"),
        "devices": parallel.pods * parallel.data * parallel.model,
        "iso": iso_on, "num_chunks": num_chunks if iso_on else 1,
        "compile_s": round(t_trace, 1),
        "flops_per_device": trace.flops,
        "bytes_per_device": float(trace.bytes),
        "collective_counts": dict(coll.counts),
        "collective_wire_bytes_per_device": coll.wire_bytes,
        "memory": {
            "args_bytes": args_bytes,
            "out_bytes": out_bytes,
            "temp_bytes": trace.peak_temp_bytes,
            "code_bytes": 0,
        },
    }
    report["roofline"] = roofline_terms(report, cfg, shape)
    if verbose:
        r = report["roofline"]
        ov = overlap_metric(trace)
        print(f"OK {arch} x {shape_name} [{report['mesh']}] "
              f"iso={'on' if iso_on else 'off'} "
              f"trace={report['compile_s']}s "
              f"compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s "
              f"collective={r['collective_s']:.2e}s -> {r['bottleneck']}")
        print(f"   collectives {report['collective_counts']} wire "
              f"{coll.wire_bytes:.4e} B/device; hideable_fraction "
              f"{ov['hideable_fraction']:.4f} (avg_hideable_dots "
              f"{ov['avg_hideable_dots']:.2f} of {ov.get('total_dots', 0)} "
              f"dots over {ov['collectives']} collectives)")
    return report, trace


def lower_shape(arch: str, shape_name: str, **kw) -> Optional[Dict[str, Any]]:
    """Trace one (arch, shape, mesh) cell on rank 0; return the report
    (the reference's keys; ``compile_s`` is the trace's seconds)."""
    res = trace_shape(arch, shape_name, **kw)
    return None if res is None else res[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--iso-off", action="store_true")
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--policy", type=str, default="even")
    ap.add_argument("--blockwise-attn", action="store_true")
    ap.add_argument("--grad-int8", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import ASSIGNED
    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    reports, overlaps, failures = [], [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    r = trace_shape(arch, shape, multi_pod=mp,
                                    iso_on=not args.iso_off,
                                    quantized=args.quantized,
                                    num_chunks=args.chunks,
                                    policy=args.policy,
                                    blockwise_attn=args.blockwise_attn,
                                    grad_int8=args.grad_int8,
                                    zero1=args.zero1)
                    if r is not None:
                        reports.append(r[0])
                        overlaps.append(dict(arch=arch, shape=shape,
                                             multi_pod=mp,
                                             **overlap_metric(r[1])))
                except Exception as e:  # noqa: BLE001 - report, keep sweeping
                    failures.append((arch, shape, mp, repr(e)[:400]))
                    print(f"FAIL {arch} x {shape} multi_pod={mp}: {e!r}"[:500])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"reports": reports, "overlap": overlaps,
                       "failures": failures}, f, indent=1)
    print(f"\n{len(reports)} OK, {len(failures)} FAIL")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
