"""Dry run: the roofline terms of every (architecture x shape x mesh) cell,
and, on the card, one period of the cell measured against them.

The port of ``repro/launch/dryrun.py``.  The JAX dry run lowers and
compiles each cell for 512 placeholder devices and reads XLA's
``memory_analysis`` and ``cost_analysis``; torch has no compiled analysis,
so the port has two passes, and both write the JAX JSON keys that have a
counterpart (to ``experiments/dryrun_torch/*.json``):

* the structural pass (no card): the model on ``meta``, its parameter,
  optimizer-state, batch and cache shards per device from the sharding
  rules (the counterpart of ``argument_size_in_bytes``), and the analytic
  cost model's FLOPs, bytes and collective bytes with the H100 ``HW``
  table (``launch/mesh.py``).  The collective bytes are the analytic
  ones: there is no HLO to parse, so ``flops_per_device_hlo``,
  ``bytes_per_device_hlo``, ``collectives*``, ``hlo_bytes``, ``lower_s``
  and ``compile_s`` have no counterpart.  The port's attention always
  skips the tiles the causal mask empties, so the cost is taken with
  ``causal_skip=True``.
* the measured pass (``--measure``, the card only): one period of the
  architecture at its published widths, at one device's share of the
  single-pod mesh under the ``fsdp`` layout (``global_batch // 256``
  sequences, at least one, at the cell's length): the train step with the
  cell's optimizer, the prefill forward keeping the last position's
  logits, or one decode step against a cache of the cell's length.  Its
  ``measured`` block holds the median time, the peak memory and two
  shares of the analytic cost of that period on one device:
  ``compute_fraction`` (exact FLOPs over the bf16 peak, over the time) and
  ``measured_fraction`` (the larger of that and the model's bytes over
  the memory rate, over the time).  A period that does not fit the card
  is recorded with its bytes and no time.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2_5_3b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh single
    python -m repro_torch.launch.dryrun --all --mesh single --measure
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import SHAPES, dryrun_cells, get_config, input_specs
from repro_torch.configs.base import ShapeSpec, shape_applicable
from repro_torch.core.execution import resolve_device
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.interop import leaf_groups, nest
from repro_torch.launch.costmodel import analytic_cost
from repro_torch.launch.mesh import HW, MESHES, Mesh, make_mesh
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as OPT
from repro_torch.train.trainer import TrainConfig, Trainer

__all__ = ["OUT_DIR", "pick_optimizer", "build_cell", "run_cell",
           "measure_cell", "roofline_terms", "mesh_dp_tp", "one_period",
           "param_leaves", "opt_leaves", "cache_leaves", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: the measured pass runs one device's share of the single-pod mesh under
#: the fsdp layout: the batch is split over all its devices
MEASURE_DEVICES = 256
#: timed runs after one warm-up; one when the warm-up took over SLOW_S
MEASURE_RUNS, SLOW_S = 3, 10.0
#: a measured cell's limit in a ``--all --measure`` sweep (one process a
#: cell); a cell that runs longer is recorded as such
CELL_TIMEOUT_S = 600


def pick_optimizer(n_params: int) -> str:
    return "adafactor" if n_params > 50e9 else "adamw"


def one_period(cfg: T.ModelConfig) -> T.ModelConfig:
    """``cfg`` cut to one period of its pattern (an encoder-decoder
    model's encoder too)."""
    return dataclasses.replace(
        cfg, n_layers=cfg.period,
        n_enc_layers=cfg.period if cfg.enc_dec else 0)


# ---------------------------------------------------------------------------
# leaves: the JAX package's trees as {path: tensor on meta}
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def param_leaves(model: T.Model) -> Dict[str, torch.Tensor]:
    """The model's weights as the JAX package's leaves on ``meta``: a
    decoder or encoder weight stacked over the periods."""
    return {k: _meta(((len(ps),) if stacked else ()) + tuple(ps[0].shape),
                     ps[0].dtype)
            for k, ps, stacked in leaf_groups(model)}


def opt_leaves(kind: str, params: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """The optimizer state of ``params`` (leaves on ``meta``) as the JAX
    package's leaves: ``m/<path>``, ``v/<path>``, ``slots/<path>/vr``,
    ``count``."""
    state = OPT.make_optimizer(kind).init(list(params.values()))
    keys = list(params)
    return SH.flatten({k: nest(keys, v) if isinstance(v, list) else v
                       for k, v in state.items()})


def cache_leaves(cfg: T.ModelConfig, B: int, S: int
                 ) -> Dict[str, torch.Tensor]:
    """The decode cache's leaves as the JAX package stacks them,
    ``(period, B, ...)``: the shapes of the port's list of periods,
    stacked."""
    cache = T.init_cache(cfg, B, S, device="meta")
    return {k: _meta((len(cache),) + tuple(v.shape), v.dtype)
            for k, v in SH.flatten(cache[0]).items()}


# ---------------------------------------------------------------------------
# the structural pass
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, mesh: Mesh, cfg=None):
    """Returns ``(meta, args)``: the cell's JSON fields that come from the
    model, and ``{group: (leaves, specs)}`` of the step's arguments
    (``params``, ``opt_state``, ``batch``, ``cache``)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise SystemExit(f"{arch} x {shape_name}: {why}")

    model = T.init_params(cfg, device="meta")
    params = param_leaves(model)
    n_params = sum(x.numel() for x in params.values())
    pspecs = SH.param_specs(cfg, params, mesh)
    dp = SH.dp_axes(mesh)
    args = {"params": (params, pspecs)}

    n_active = T.active_param_count(cfg, model)
    tokens_processed = (shape.global_batch *
                        (1 if shape.kind == "decode" else shape.seq_len))
    if cfg.enc_dec and shape.kind != "decode":
        tokens_processed = shape.global_batch * (
            shape.seq_len + shape.seq_len // cfg.dec_len_ratio)
    # MODEL_FLOPS: 6ND train (fwd+bwd), 2ND inference (fwd only)
    mf = (6 if shape.kind == "train" else 2) * n_active * tokens_processed
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "n_params": int(n_params), "n_active_params": int(n_active),
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
            "model_flops_global": float(mf)}

    if shape.kind in ("train", "prefill"):
        batch = input_specs(cfg, shape)
        args["batch"] = (batch, SH.batch_specs(cfg, batch, mesh))
        if shape.kind == "train":
            opt_kind = pick_optimizer(n_params)
            opt = opt_leaves(opt_kind, params)
            args["opt_state"] = (opt, SH.opt_specs(pspecs, opt, mesh))
            meta["optimizer"] = opt_kind
        return meta, args

    # decode: the cache, one new token a sequence, the current length and
    # (enc-dec) the encoder's states in bf16
    B, S = shape.global_batch, shape.seq_len
    cache = cache_leaves(cfg, B, S)
    args["cache"] = (cache, SH.cache_specs(
        cfg, cache, mesh, seq_shard=shape.name == "long_500k"))
    batch = {"tokens": _meta((B, 1), torch.int32),
             "cur_len": _meta((), torch.int32)}
    bspecs = {"tokens": SH.guard_spec((dp, None), (B, 1), mesh),
              "cur_len": ()}
    if cfg.enc_dec:
        batch["enc_out"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        bspecs["enc_out"] = SH.guard_spec((dp, None, None), (B, S,
                                                             cfg.d_model),
                                          mesh)
    args["batch"] = (batch, bspecs)
    return meta, args


def mesh_dp_tp(mesh_shape, layout: str):
    """The data- and tensor-parallel degrees the cost model takes for a
    mesh under a layout: (pod x data, model), or (all, 1) when the model
    axis is data parallelism (fsdp, zero1)."""
    dp = 1
    for ax in ("pod", "data"):
        dp *= mesh_shape.get(ax, 1)
    tp = mesh_shape.get("model", 1)
    if layout in ("fsdp", "zero1"):             # model axis became DP
        dp, tp = dp * tp, 1
    return dp, tp


def roofline_terms(ac, model_flops_global: float, n_dev: int) -> Dict:
    """The roofline fields of a cell's JSON from its analytic cost, with
    the H100 ``HW`` table; the collective term is the analytic one."""
    r = {"flops_per_device": ac.flops,
         "bytes_per_device": ac.hbm_bytes,
         "collective_bytes_analytic": ac.coll_bytes,
         "collective_bytes_per_device": ac.coll_bytes,
         "t_compute": ac.flops / HW["peak_flops_bf16"],
         "t_memory": ac.hbm_bytes / HW["hbm_bw"],
         "t_collective": ac.coll_bytes / HW["ici_bw"]}
    r["t_collective_analytic"] = r["t_collective"]
    terms = {"compute": r["t_compute"], "memory": r["t_memory"],
             "collective": r["t_collective"]}
    r["bottleneck"] = max(terms, key=terms.get)
    mf_dev = model_flops_global / n_dev
    r["useful_flops_ratio"] = (mf_dev / ac.flops) if ac.flops else 0.0
    # roofline fraction: useful model flops over the time the dominant
    # term implies (how close the cell is to the compute roofline)
    t_dom = max(terms.values())
    r["roofline_fraction"] = (
        (mf_dev / HW["peak_flops_bf16"]) / t_dom if t_dom else 0.0)
    return r


def run_cell(arch: str, shape_name: str, mesh: Mesh, mesh_name: str,
             *, save: bool = True, verbose: bool = True,
             cfg=None, tag: str = "", measure: bool = False) -> Dict:
    """One cell's JSON: the structural pass, and with ``measure`` the
    measured one (on the card)."""
    n_dev = mesh.size
    meta, args = build_cell(arch, shape_name, mesh, cfg=cfg)
    if cfg is None:
        cfg = get_config(arch)
    layout = SH.get_layout()
    dp, tp = mesh_dp_tp(mesh.shape, layout)
    ac = analytic_cost(cfg, SHAPES[shape_name], n_dev, dp=dp, tp=tp,
                       causal_skip=True, zero1=layout == "zero1")
    arg_bytes = {k: SH.shard_bytes(leaves, specs, mesh)
                 for k, (leaves, specs) in args.items()}

    result = dict(meta)
    result.update({
        "mesh": mesh_name,
        "n_devices": n_dev,
        "layout": layout,
        "causal_skip": True,
        "collective_bytes_from": "analytic cost model (no HLO)",
        "argument_bytes": arg_bytes,
        "memory": {"argument_size_in_bytes": float(sum(arg_bytes.values()))},
    })
    result.update(roofline_terms(ac, meta["model_flops_global"], n_dev))
    if measure:
        result["measured"] = measure_cell(arch, shape_name, cfg=cfg,
                                          n_params=meta["n_params"])

    if verbose:
        print(f"[{arch} x {shape_name} @ {mesh_name}] flops/dev "
              f"{ac.flops:.3e} | bytes/dev {ac.hbm_bytes:.3e} | coll/dev "
              f"{ac.coll_bytes:.3e} (analytic) | args/dev "
              f"{sum(arg_bytes.values()) / 1e9:.2f} GB | bottleneck "
              f"{result['bottleneck']}")
        if measure:
            print(f"  measured: {_measured_line(result['measured'])}")
    if save:
        save_result(result, tag)
    return result


def save_result(result: Dict, tag: str = "") -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(OUT_DIR, f"{result['arch']}__{result['shape']}__"
                                 f"{result['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return path


# ---------------------------------------------------------------------------
# the measured pass
# ---------------------------------------------------------------------------

def card_name_and_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def measured_shares(block: Dict, cfg: T.ModelConfig, kind: str) -> Dict:
    """The analytic cost of the measured period on one device and the two
    shares of its time: ``compute_fraction`` = t_compute / t and
    ``measured_fraction`` = max(t_compute, t_memory) / t."""
    shape = ShapeSpec("measured", block["seq_len"], block["B_card"], kind)
    ac = analytic_cost(one_period(cfg), shape, 1, dp=1, tp=1,
                       causal_skip=True)
    out = {"flops": ac.flops, "bytes": ac.hbm_bytes,
           "t_compute": ac.flops / HW["peak_flops_bf16"],
           "t_memory": ac.hbm_bytes / HW["hbm_bw"]}
    if block.get("ms"):
        t = block["ms"] * 1e-3
        out["compute_fraction"] = out["t_compute"] / t
        out["measured_fraction"] = max(out["t_compute"], out["t_memory"]) / t
    return out


def _need_bytes(cfg: T.ModelConfig, shape: ShapeSpec, opt_kind: str) -> int:
    """The bytes one period's step must hold on the card before any
    temporary: its arguments, and for a train step the gradients."""
    params = param_leaves(T.init_params(cfg, device="meta"))
    need = _nbytes(params.values())
    if shape.kind == "train":
        need += need + _nbytes(opt_leaves(opt_kind, params).values())
    if shape.kind == "decode":
        need += _nbytes(cache_leaves(cfg, shape.global_batch,
                                     shape.seq_len).values())
    return need + _nbytes(input_specs(cfg, shape).values())


def _step_fn(cfg: T.ModelConfig, shape: ShapeSpec, opt_kind: str, dev,
             seed: int):
    """``(fn, argument bytes)``: one call of the cell's step on the card,
    with its weights (seeded), optimizer state, batch and cache."""
    B, S = shape.global_batch, shape.seq_len
    enc = None
    if cfg.enc_dec:
        # the frontend stub's frames (float32), or for a decode step the
        # encoder's states in the model's dtype (bf16 at published widths)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        enc = torch.randn((B, S, cfg.d_model), generator=g, device=dev,
                          dtype=torch.float32 if shape.kind != "decode"
                          else cfg.dtype)
    if shape.kind == "train":
        S_dec = S // cfg.dec_len_ratio if cfg.enc_dec else S
        tr = Trainer(cfg, TrainConfig(optimizer=opt_kind, warmup=0,
                                      seed=seed),
                     seq_len=S_dec, global_batch=B, device=dev)
        tr.init_state()
        batch = to_device(SyntheticLM(cfg.vocab_size, S_dec, B,
                                      seed=seed).batch(0), dev)
        if enc is not None:
            batch["enc_embeds"] = enc
        state = [tr.opt_state["count"]] + [
            t for v in tr.opt_state.values() if isinstance(v, list)
            for t in SH.flatten(v).values()]
        args = _nbytes(tr.params) + _nbytes(state) + _nbytes(batch.values())
        return (lambda: tr.train_step(batch, 0)), args

    model = T.init_params(cfg, seed, dev)
    args = _nbytes(model.parameters())
    if shape.kind == "prefill":
        S_dec = S // cfg.dec_len_ratio if cfg.enc_dec else S
        batch = {"tokens": to_device(SyntheticLM(cfg.vocab_size, S_dec, B,
                                                 seed=seed).batch(0),
                                     dev)["tokens"]}
        if enc is not None:
            batch["enc_embeds"] = enc
        args += _nbytes(batch.values())

        @torch.inference_mode()
        def prefill():
            logits, _ = T.forward(cfg, model, batch)
            # only the last position's logits are kept (serving prefill)
            return logits[:, -1, :]
        return prefill, args

    cache = T.init_cache(cfg, B, S, dev)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, 1), dtype=np.int32)).to(dev)
    args += _nbytes(SH.flatten(cache).values()) + _nbytes([tokens])
    if enc is not None:
        args += _nbytes([enc])

    @torch.inference_mode()
    def decode():
        # the cache holds S - 1 positions; the new token makes S
        return T.decode_step(cfg, model, cache, tokens, S - 1, enc_out=enc)
    return decode, args


def measure_cell(arch: str, shape_name: str, cfg=None, *,
                 n_params=None) -> Dict:
    """The ``measured`` block of one cell (the card only; raises without
    one): one period at ``max(1, global_batch // 256)`` sequences of the
    cell's length with weights from seed 0, its median time over
    ``MEASURE_RUNS`` timed runs after a warm-up, its peak memory, and the
    shares of its analytic cost."""
    dev = resolve_device(None)
    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape_name]
    one = one_period(cfg)
    B = max(1, shape.global_batch // MEASURE_DEVICES)
    cut = ShapeSpec(shape.name, shape.seq_len, B, shape.kind)
    if n_params is None:
        n_params = T.param_count(T.init_params(cfg, device="meta"))
    opt_kind = pick_optimizer(n_params)
    block = {"B_card": B, "seq_len": shape.seq_len, "periods": 1,
             "n_layers": one.n_layers, "layout": "fsdp",
             "card": card_name_and_limit()}
    if shape.kind == "train":
        block["optimizer"] = opt_kind
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    need = _need_bytes(one, cut, opt_kind)
    block.update(need_bytes=need, card_bytes=card_bytes)
    if need > card_bytes:
        block.update(fits=False, reason=(
            f"one period needs {need / 1e9:.1f} GB of arguments"
            f"{' and gradients' if shape.kind == 'train' else ''} before any "
            f"temporary; the card has {card_bytes / 1e9:.1f} GB"))
        block.update(measured_shares(block, cfg, shape.kind))
        return block

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fn, arg_bytes = _step_fn(one, cut, opt_kind, dev, 0)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    warm = time.perf_counter() - t0
    times = []
    for _ in range(1 if warm > SLOW_S else MEASURE_RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    block.update(fits=True, ms=1e3 * statistics.median(times),
                 runs=len(times), warmup_ms=1e3 * warm,
                 peak_bytes=peak, argument_bytes=arg_bytes,
                 temp_bytes=peak - arg_bytes)
    block.update(measured_shares(block, cfg, shape.kind))
    del fn
    torch.cuda.empty_cache()
    return block


def _measured_line(m: Dict) -> str:
    if not m.get("fits", True):
        return f"does not fit: {m['reason']}"
    if "ms" not in m:
        return m.get("reason", "not measured")
    return (f"B {m['B_card']} x S {m['seq_len']}, 1 period: "
            f"{m['ms']:.2f} ms (median of {m['runs']}), peak "
            f"{m['peak_bytes'] / 1e9:.2f} GB (temp "
            f"{m['temp_bytes'] / 1e9:.2f}), compute_fraction "
            f"{m['compute_fraction']:.4f}, measured_fraction "
            f"{m['measured_fraction']:.4f} [{m['card']}]")


def _measure_in_child(arch: str, shape: str, mesh_name: str
                      ) -> Optional[Dict]:
    """Run one cell's measured pass in its own process (which saves the
    JSON; a fresh process a cell, so no cell inherits another's cached
    memory) and return ``None``; a ``measured`` block saying why when it
    ran past ``CELL_TIMEOUT_S`` or failed."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", mesh_name, "--measure"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=CELL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {"reason": f"exceeded the {CELL_TIMEOUT_S} s limit of a cell"}
    print(out.stdout, end="")
    if out.returncode != 0:
        tail = out.stderr.strip().splitlines()[-1:] or ["?"]
        return {"reason": f"exit {out.returncode}: {tail[0][:160]}"}
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=sorted(MESHES), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--measure", action="store_true",
                    help="also run one period of each cell on the card")
    args = ap.parse_args(argv)

    mesh = make_mesh(args.mesh)
    if not args.all:
        run_cell(args.arch, args.shape, mesh, args.mesh,
                 measure=args.measure)
        return
    if args.measure:
        resolve_device(None)                 # the card, or raise now
    for arch, shape in dryrun_cells():
        r = run_cell(arch, shape, mesh, args.mesh)
        if args.measure:
            failed = _measure_in_child(arch, shape, args.mesh)
            if failed is not None:
                r["measured"] = failed
                save_result(r)
                print(f"  measured: {failed['reason']}")


if __name__ == "__main__":
    main()
