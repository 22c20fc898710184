"""Batched serving: prefill + greedy decode loop over a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b \
        --smoke --batch 4 --prompt-len 16 --gen 16 --device cpu

``--arch`` takes any of ``configs.list_archs()``.

The port of ``repro/launch/serve.py``: the prompt goes into the cache
token by token through ``decode_step``, then ``--gen`` tokens are decoded
greedily.  It runs on the card unless ``--device`` names another device.
``generate`` is the loop, callable on its own.  An encoder-decoder model
(whisper) gets the JAX package's encoder stub: a seeded normal
(B, 2 * prompt_len, d) in the model's dtype stands for the encoder's
states, passed to every decode step without running the encoder.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.execution import resolve_device
from repro_torch.models import transformer as T

__all__ = ["Generation", "generate", "main"]


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor        # (B, gen) int64, the greedy tokens
    logits: torch.Tensor        # (B, gen, padded_vocab) f32, the logits
                                # each token was taken from
    prefill_s: float            # host seconds of the prompt, synchronised
    decode_s: float             # host seconds of the gen - 1 decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(cfg: T.ModelConfig, model: T.Model, prompts: torch.Tensor,
             gen: int, enc_out=None) -> Generation:
    """Prefill ``prompts`` (B, P) token by token, then decode greedily
    until ``gen`` tokens are out (the first comes from the prompt's last
    logits).  Tokens are taken among the first ``cfg.vocab_size`` logits.
    ``enc_out`` (B, S_enc, d): an encoder-decoder model's encoder states,
    handed to every ``decode_step``.  It runs under
    ``torch.inference_mode``, so a model whose weights are trainable
    builds no graph here."""
    if gen < 1:
        raise ValueError(f"generate: gen={gen} must be at least 1")
    B, P = prompts.shape
    device = prompts.device
    max_len = P + gen
    cache = T.init_cache(cfg, B, max_len, device)

    t0 = time.perf_counter()
    for t in range(P):
        logits, cache = T.decode_step(cfg, model, cache, prompts[:, t:t + 1],
                                      t, enc_out)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
    toks, outs = [tok], [logits]
    t0 = time.perf_counter()
    for t in range(P, max_len - 1):
        logits, cache = T.decode_step(cfg, model, cache, tok, t, enc_out)
        tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
        toks.append(tok)
        outs.append(logits)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return Generation(torch.cat(toks, dim=1), torch.cat(outs, dim=1),
                      prefill_s, decode_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    model = T.init_params(cfg, args.seed, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    enc_out = None
    if cfg.enc_dec:
        enc_out = torch.randn((args.batch, 2 * args.prompt_len, cfg.d_model),
                              generator=gen, dtype=cfg.dtype, device=device)
    out = generate(cfg, model, prompts, args.gen, enc_out)

    n_dec = max(args.gen - 1, 1)
    print(f"arch={cfg.name} B={args.batch} prompt={args.prompt_len} "
          f"gen={out.tokens.shape[1]} device={device}")
    print(f"prefill: {out.prefill_s * 1e3:.0f} ms | decode: "
          f"{out.decode_s / n_dec * 1e3:.1f} ms/token")
    print("sample generations:", out.tokens[:2, :10].tolist())
    if not torch.isfinite(out.logits).all():
        raise RuntimeError("serve: non-finite logits")
    print("serve OK")


if __name__ == "__main__":
    main()
