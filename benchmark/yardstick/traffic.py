"""The one generator every traffic file feeds, and the seeds it draws
from.

A training mix is a closed loop: the steps run back to back, each on
the next of ``batches`` batches of ``batch`` x ``seq`` tokens, made on
the device from the seed (and, where every rank takes its own data,
the rank). Token ids follow a Zipf law of exponent ``zipf_s`` over the
vocabulary, whose ranks a permutation drawn from the same seed assigns
to ids: the unigram law of text, so MoE routing is skewed as real text
skews it. Targets are the tokens shifted by one position.
"""

import hashlib

import torch


def derive(seed, stream):
    """A 63-bit seed for ``stream`` (a string) from the run's ``seed``:
    every stream draws apart, and the same seed gives the same draws."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed, stream, device):
    return torch.Generator(device=device).manual_seed(derive(seed, stream))


def batches(traffic, vocab, seed, rank, device):
    """``(tokens, targets)``, each ``(batches, batch, seq)`` int64 on
    ``device``."""
    n, b, s = traffic["batches"], traffic["batch"], traffic["seq"]
    stream = f"tokens:{rank}" if traffic.get("per_rank_data") else "tokens"
    gen = generator(seed, stream, device)
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    law = ranks.pow(-float(traffic["zipf_s"]))
    ids = torch.multinomial((law / law.sum()).float(), n * b * (s + 1),
                            replacement=True, generator=gen)
    perm = torch.randperm(vocab, generator=gen, device=device)
    rows = perm[ids].view(n, b, s + 1)
    return rows[..., :-1].contiguous(), rows[..., 1:].contiguous()
