"""Serving driver: batched prefill + greedy decode (a port of
``repro/launch/serve.py``).

Serves a model of any family with batched greedy decoding on the card
(``--device cuda``, the default) or on the CPU.  Prompts are synthetic,
drawn from an explicit ``torch.Generator``: tokens, or for the audio
family frame embeddings (each decode step embeds the sampled code
through ``params["embed"]``), and for the VLM image embeddings, carried
through prefill into the image K/V cache.  Greedy ``argmax`` stays on the
device and the tokens come to the host once, at the end.

  python -m repro_torch.launch.serve --arch granite_8b --preset full \\
      --batch 8 --prompt-len 2048 --gen-len 64
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models import model as model_mod


def synthetic_prompt(cfg, batch: int, prompt_len: int, seed: int,
                     device) -> dict:
    """The prompt batch, drawn by a generator on ``device`` seeded with
    ``seed + 1``: (batch, prompt_len) int64 tokens uniform over the
    vocabulary, or for the audio family (batch, prompt_len, d_model) frame
    embeddings; for the VLM also (batch, n_img_tokens, d_model) image
    embeddings.  Embeddings are normal times 0.02 in ``cfg.dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def embeds(n):
        return layers.normal((batch, n, cfg.d_model), 0.02,
                             layers.dtype_of(cfg), gen, device)
    out = {}
    if cfg.family == "audio":
        out["embeds"] = embeds(prompt_len)
    else:
        out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                      generator=gen, device=device)
    if cfg.family == "vlm":
        out["img_embeds"] = embeds(cfg.n_img_tokens)
    return out


def step_batch(params, cfg, prompt: dict, tok: torch.Tensor,
               position) -> dict:
    """The decode step's batch for the sampled tokens ``tok`` (B,) at
    ``position`` (an int or (B,) int32): their embedding rows for the
    audio family, else the tokens; the VLM's image embeddings ride along,
    as in the reference (decode reads the cached image K/V)."""
    B = tok.shape[0]
    out = {"positions": torch.as_tensor(position, dtype=torch.int32,
                                        device=tok.device).expand(B)
           .contiguous()}
    if cfg.family == "audio":
        out["embeds"] = params["embed"][tok][:, None, :]
    else:
        out["tokens"] = tok[:, None]
    if cfg.family == "vlm":
        out["img_embeds"] = prompt["img_embeds"]
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg, prompt: dict, gen_len: int, stats) -> torch.Tensor:
    """Prefill ``prompt`` (``synthetic_prompt``'s dict, P positions), then
    ``gen_len - 1`` greedy decode steps.  Returns the (B, gen_len)
    generated tokens on the device.

    ``stats``, a dict, receives the prefill and decode seconds and, by
    reference, the logits of the prefill's last position, of the first
    decode step (position P) and of the last step, each (B, V)."""
    first = prompt["embeds"] if cfg.family == "audio" else prompt["tokens"]
    B, P = first.shape[:2]
    dev = first.device
    cache = model_mod.init_cache(cfg, B, P + gen_len, device=dev)
    _sync(dev)
    t0 = time.time()
    logits, cache = model_mod.prefill(params, cfg, prompt, cache,
                                      last_only=True)
    _sync(dev)
    t_prefill = time.time() - t0
    stats["prefill_logits"] = logits[:, -1]
    next_tok = torch.argmax(logits[:, -1, :], dim=-1)
    toks = [next_tok]
    t0 = time.time()
    for i in range(gen_len - 1):
        step = step_batch(params, cfg, prompt, next_tok, P + i)
        logits, cache = model_mod.decode_step(params, cfg, step, cache)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1)
        toks.append(next_tok)
        if i == 0:
            stats["first_decode_logits"] = logits[:, 0]
    _sync(dev)
    t_decode = time.time() - t0
    stats.update(prefill_s=t_prefill, decode_s=t_decode,
                 last_logits=logits[:, -1])
    return torch.stack(toks, dim=1)


def main(argv=None, params=None, stats=None, cfg=None):
    """Serve one synthetic batch and return its generated tokens (B, gen)
    on the host.  ``params`` (the port's tree, e.g. carried across from
    the reference by ``models/convert.py``) replaces the random ones;
    ``cfg`` replaces the config that ``--arch`` and ``--preset`` name (a
    depth cut, say); a ``stats`` dict receives the prompt and what
    ``generate`` records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--preset", choices=("tiny", "full"), default="tiny")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if cfg is None:
        cfg = get_config(args.arch) if args.preset == "full" else \
            reduced(get_config(args.arch))
    dev = resolve_device(args.device)
    B, P, G = args.batch, args.prompt_len, args.gen_len
    print(f"[serve] arch={args.arch} preset={args.preset} batch={B} "
          f"prompt={P} gen={G}")
    with torch.inference_mode():
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            params = model_mod.init_params(cfg, generator=gen, device=dev)
        prompt = synthetic_prompt(cfg, B, P, args.seed, dev)
        times = {} if stats is None else stats
        times["prompt"] = prompt
        out = generate(params, cfg, prompt, G, times).cpu()
    t_prefill, t_decode = times["prefill_s"], times["decode_s"]
    print(f"[serve] prefill: {B*P} tokens in {t_prefill:.3f}s "
          f"({B*P/t_prefill:.0f} tok/s)")
    print(f"[serve] decode:  {B*(G-1)} tokens in {t_decode:.3f}s "
          f"({B*(G-1)/max(t_decode,1e-9):.0f} tok/s)")
    print(f"[serve] sample output ids[0,:16]: {out[0,:16].tolist()}")
    assert bool(torch.all((out >= 0) & (out < cfg.padded_vocab)))
    return out


if __name__ == "__main__":
    main()
