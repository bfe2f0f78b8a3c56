"""Batched serving on the PyTorch port: prefill + decode with KV/SSM
caches for three architecture families (dense GQA, MLA, hybrid SSM),
driven by the ServeEngine with completion-unit tracking per step — the
twin of ``examples/serve_batch.py``, at the same reduced sizes.

On the card the dense model's and the hybrid's shared block's attention
run the flash kernel and the hybrid's Mamba-2 layers the scan kernel, at
head dim 32; MLA's split head dims run the plain attention.  The engine's
window is 8 logical clusters, the reference's 4 x 2 mesh, so the weight
placement counts the same host-link and device-to-device bytes.  The
weights come from a ``torch.Generator``, so the sampled ids are not the
reference's.

    PYTHONPATH=src python examples/torch_serve_batch.py             # the card
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""

import argparse
import time

import torch

from repro_torch import models as M
from repro_torch.api import ServeConfig, ServeEngine, Staging
from repro_torch.data import DataConfig, SyntheticStream

CLUSTERS = 8
ARCHS = ("smollm-360m", "deepseek-v2-lite-16b", "zamba2-2.7b")


def model_and_prompts(arch: str, batch: int = 4, prompt: int = 16):
    """The reduced ``arch``, its weights (on the CPU) and a batch of
    ``batch`` prompts of ``prompt`` tokens, all from fixed seeds."""
    cfg = M.reduced(M.get(arch))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    stream = SyntheticStream(
        DataConfig(vocab_size=cfg.vocab_size, batch_size=batch,
                   seq_len=prompt, seed=1), cfg)
    return cfg, params, stream.batch(0)


def demo(arch: str, device: str, batch: int = 4, prompt: int = 16,
         new: int = 24) -> None:
    cfg, params, ex = model_and_prompts(arch, batch, prompt)

    engine = ServeEngine(cfg, params,
                         ServeConfig(batch=batch, max_len=prompt + new + 1,
                                     temperature=0.8, seed=7,
                                     staging=Staging.TREE),
                         device=device, cluster_ids=range(CLUSTERS))
    # typed tree staging: replicated weight leaves cross the host link
    # once and fan out device-to-device (stats below count the bytes)
    engine.place_params(params)
    extra = {k: v for k, v in ex.items() if k == "patches"}
    t0 = time.time()
    out = engine.generate(ex["tokens"], new, extra or None)
    dt = time.time() - t0
    cache_kind = ("compressed-KV (MLA)" if cfg.mla
                  else "SSM state" if cfg.ssm else "KV")
    print(f"{arch:24s} [{cfg.family:6s}] cache={cache_kind:20s} "
          f"{batch * new} tokens in {dt:5.1f}s ({batch * new / dt:6.1f} tok/s)")
    print(f"  weight placement: {engine.stats['h2d_bytes'] / 1e6:.1f} MB "
          f"host-link, {engine.stats['d2d_bytes'] / 1e6:.1f} MB d2d "
          f"(staging={engine.scfg.staging.value})")
    print(f"  sample: {out[0][:12].tolist()}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    for arch in ARCHS:
        demo(arch, args.device)


if __name__ == "__main__":
    main()
