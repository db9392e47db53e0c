"""The links between the cards of one host, for a collective's share of
their peak.

A card of the four-card cell is an H100 SXM on NVLink 4: 18 links of
25 GB/s a direction each, 450 GB/s a direction (NVIDIA's H100 data sheet:
900 GB/s of NVLink bandwidth, both directions together). On the card
machine ``nvidia-smi nvlink -s`` reads 18 links of 26.562 GB/s a card (the
links' signalling rate) and every pair of cards has peer access
(``nvidia-smi topo -m`` does not run there).

The peak is the data sheet's 450 GB/s and not the 478 GB/s of 18 x
26.562: 26.562 GB/s is a link's line rate (two lanes of 106.25 Gbit/s),
of which the data sheet's 25 GB/s is what carries data. Against 478 the
share would read 6% lower.
"""
from __future__ import annotations

PEAK_LINK_BYTES = 450e9      # NVLink 4, one card, bytes a second a direction


def ring_allreduce_bytes(nbytes: float, ranks: int) -> float:
    """Bytes a ring all-reduce of ``nbytes`` moves over each card's link in
    each direction: 2 (n - 1) / n of the buffer (NCCL's bus bandwidth
    counts the same)."""
    return nbytes * 2 * (ranks - 1) / ranks
