"""Batched serving driver (twin of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --reduced --batch 4 --prompt-len 16 --new-tokens 32

Runs on the card (``--device cuda``, the default, which raises without
one); ``--device cpu`` serves on the CPU with the plain attention.
Continuous batching (variable-length requests streamed into the fixed
decode batch under a Poisson-ish arrival trace):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --reduced --batch 4 --continuous --requests 8 --arrival-rate 0.5

Serving as a lease-holding fabric tenant (a ``--serve-floor`` cluster
floor of the device's 32 logical clusters, grown into the free clusters
for each decode burst):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --reduced --batch 4 --fabric --serve-floor 1

The weights are random, drawn from ``--seed`` on the host, and placed on
the device under ``--staging``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.fabric import FabricScheduler
from repro_torch.core.policy import Staging
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.models import get, init_params, reduced
from repro_torch.serve import ServeConfig, ServeEngine, ServeTenant
from repro_torch.serve.engine import resolve_device


def continuous_trace(n: int, lo: int, hi: int, new_tokens: int,
                     arrival_rate: float, vocab_size: int, seed: int):
    """A streamed-request trace: ``n`` prompts of lengths in [lo, hi]
    under a Poisson-ish arrival process (``arrival_rate`` arrivals per
    decode step) -> (requests, arrival steps, prompt lengths)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    reqs = [(rng.integers(0, vocab_size, (int(s),)).astype(np.int32),
             new_tokens) for s in lens]
    gaps = rng.poisson(1.0 / max(arrival_rate, 1e-6), size=n)
    arrivals = np.cumsum(gaps) - gaps[0]
    return reqs, arrivals, lens


def _continuous_trace(args, cfg):
    """The streamed-request trace both packages' CLIs draw: the same
    draws as ``repro.launch.serve``'s for the same flags."""
    return continuous_trace(args.requests, max(2, args.prompt_len // 2),
                            args.prompt_len, args.new_tokens,
                            args.arrival_rate, cfg.vocab_size, args.seed)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="the device to serve on (cuda, cuda:N or cpu)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-mode", default="step",
                    choices=["step", "chunk", "host"],
                    help="decode loop: device-resident step, chunk of "
                         "steps per dispatch, or the host round trip")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="tokens per dispatch in chunk mode")
    ap.add_argument("--staging", default="direct",
                    choices=["direct", "tree", "tree_reshard"],
                    help="placement strategy for weights and prefill "
                         "inserts (repro_torch.core.policy.Staging)")
    ap.add_argument("--fabric", action="store_true",
                    help="serve as a lease-holding fabric tenant: hold a "
                         "--serve-floor cluster floor, grow to the free "
                         "fabric per decode burst, shrink back between "
                         "bursts (repro_torch.api.FabricScheduler)")
    ap.add_argument("--serve-floor", "--floor", type=int, default=1,
                    help="resident lease size between bursts (fabric mode)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: stream --requests variable-"
                         "length prompts through the slot scheduler")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of streamed requests (continuous mode)")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="mean arrivals per decode step of the Poisson-ish "
                         "trace (continuous mode)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    host = init_params(cfg, generator=torch.Generator().manual_seed(args.seed),
                       device="cpu")
    scfg = ServeConfig(batch=args.batch,
                       max_len=args.prompt_len + args.new_tokens + 1,
                       temperature=args.temperature, seed=args.seed,
                       decode_mode=args.decode_mode,
                       decode_chunk=args.decode_chunk,
                       staging=Staging(args.staging))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.fabric:
        _serve_fabric(args, cfg, host, scfg, device, sync)
        return
    engine = ServeEngine(cfg, host, scfg, device=device)
    # weight placement honours --staging
    engine.place_params(host)
    del host

    if args.continuous:
        reqs, arrivals, lens = _continuous_trace(args, cfg)
        sync()
        t0 = time.time()
        outs = engine.generate_many(reqs, arrival_steps=arrivals.tolist())
        dt = time.time() - t0
        total = sum(len(o) for o in outs)
        print(f"[serve] continuous on {device}: {args.requests} requests, "
              f"{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s, batch "
              f"{args.batch}, {engine.stats['prefill_inserts']} inserts)")
        for r in range(min(2, args.requests)):
            print(f"  req {r}: prompt_len={lens[r]} arrival={arrivals[r]} "
                  f"-> {outs[r][:12].tolist()}")
        return

    stream = SyntheticStream(
        DataConfig(vocab_size=cfg.vocab_size, batch_size=args.batch,
                   seq_len=args.prompt_len, seed=args.seed), cfg)
    prompts = stream.batch(0)["tokens"]
    sync()
    t0 = time.time()
    out = engine.generate(prompts, args.new_tokens)
    dt = time.time() - t0
    total = args.batch * args.new_tokens
    print(f"[serve] generated {total} tokens on {device} in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, batch {args.batch})")
    for b in range(min(2, args.batch)):
        print(f"  slot {b}: prompt={prompts[b][:8].tolist()}... "
              f"-> {out[b][:16].tolist()}")


def _serve_fabric(args, cfg, host, scfg, device, sync) -> None:
    """Serve as a fabric tenant: a resident floor lease, elastically grown
    to the free fabric for each decode burst; the clusters released
    between bursts are leasable by offload tenants."""
    sched = FabricScheduler(device)
    tenant = ServeTenant(sched, cfg, host, scfg,
                         floor=min(args.serve_floor, sched.num_clusters))
    sync()
    t0 = time.time()
    if args.continuous:
        reqs, arrivals, _ = _continuous_trace(args, cfg)
        outs = tenant.generate_many(reqs, arrival_steps=arrivals.tolist())
        dt = time.time() - t0
        total = sum(len(o) for o in outs)
        head = f"continuous, {args.requests} requests"
        samples = [o[:12].tolist() for o in outs[:2]]
    else:
        stream = SyntheticStream(
            DataConfig(vocab_size=cfg.vocab_size, batch_size=args.batch,
                       seq_len=args.prompt_len, seed=args.seed), cfg)
        out = tenant.generate(stream.batch(0)["tokens"], args.new_tokens)
        dt = time.time() - t0
        total = args.batch * args.new_tokens
        head = f"batch {args.batch}"
        samples = [out[b][:12].tolist() for b in range(min(2, args.batch))]
    print(f"[serve] fabric tenant ({head}): {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s); lease floor "
          f"{tenant.lease.n}/{sched.num_clusters} clusters, burst "
          f"window {tenant.peak_burst}, free between bursts: "
          f"{len(sched.free_clusters())}")
    for i, s in enumerate(samples):
        print(f"  slot {i}: -> {s}")
    tenant.close()


if __name__ == "__main__":
    main()
