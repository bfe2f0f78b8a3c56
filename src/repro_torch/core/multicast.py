"""Multicast address-mask encoding — paper §4.2, figures 4 & 5.

The paper extends the AXI XBAR address decoder so that a single write request
can target many clusters.  A request carries an address plus a *mask*: bits of
the address covered by a set mask bit are "don't care", i.e. they encode both
0 and 1.  Masking ``k`` bits therefore addresses ``2**k`` destinations.  All
clusters share the same local address map, offset by a constant stride
(0x40000 bytes in Occamy), so one (address, mask) pair reaches the same local
offset within every selected cluster.

The decode condition from the paper (verbatim, §4.2)::

    match = &((req.mask | am.mask) | ~(req.addr ^ am.addr));

i.e. a master port whose address map is (am.addr, am.mask) matches the request
(req.addr, req.mask) iff every bit either belongs to one of the two masks or
agrees between the two addresses.

In the TPU adaptation this algebra is reused one level up: it selects *which
clusters (chips) of the accelerator mesh participate in a job*.  The offload
runtime expresses "clusters 1 and 3 of quadrants 0 and 2" exactly as in
fig. 5 of the paper, and lowers the selection to a device subset of the JAX
mesh.  The hardware realization (NoC multicast) becomes a replicated-sharding
broadcast tree; the *selection semantics* are identical and are property-
tested against a brute-force oracle in ``tests/test_multicast.py``.

Occamy constants (fig. 5): bits [0,17] are the in-cluster offset, bits
[18,19] index the cluster within a quadrant, bits [20,22] index the quadrant.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Sequence, Tuple

# --- Occamy address-map constants (paper fig. 5) -------------------------------
CLUSTER_ADDR_STRIDE = 0x40000          # 256 KiB of address space per cluster
CLUSTER_OFFSET_BITS = 18               # bits [0, 17]: offset inside a cluster
CLUSTER_IDX_BITS = 2                   # bits [18, 19]: cluster within quadrant
QUADRANT_IDX_BITS = 3                  # bits [20, 22]: quadrant index
CLUSTERS_PER_QUADRANT = 1 << CLUSTER_IDX_BITS
NUM_QUADRANTS = 1 << QUADRANT_IDX_BITS
NUM_CLUSTERS = CLUSTERS_PER_QUADRANT * NUM_QUADRANTS   # 32 clusters / 256 cores
ADDR_BITS = CLUSTER_OFFSET_BITS + CLUSTER_IDX_BITS + QUADRANT_IDX_BITS


@dataclasses.dataclass(frozen=True)
class MulticastRequest:
    """A (addr, mask) pair encoding up to ``2**popcount(mask)`` destinations."""

    addr: int
    mask: int = 0

    def __post_init__(self) -> None:
        if self.addr < 0 or self.mask < 0:
            raise ValueError("addr and mask must be non-negative")
        if self.addr & self.mask:
            # Canonical form: don't-care bits are stored as 0 in the address.
            object.__setattr__(self, "addr", self.addr & ~self.mask)

    @property
    def fanout(self) -> int:
        return 1 << bin(self.mask).count("1")

    def addresses(self) -> Iterator[int]:
        """Enumerate every concrete address encoded by this request."""
        mask_bits = [b for b in range(self.mask.bit_length()) if (self.mask >> b) & 1]
        for combo in range(1 << len(mask_bits)):
            addr = self.addr
            for i, b in enumerate(mask_bits):
                if (combo >> i) & 1:
                    addr |= 1 << b
            yield addr


@dataclasses.dataclass(frozen=True)
class AddressMap:
    """A master port's address map: a power-of-two-sized, aligned interval.

    Encoded exactly like a request: ``addr`` is the base, ``mask`` covers the
    low bits spanned by the interval (length ``2**popcount(mask)``, which for
    a contiguous region means mask = length - 1).
    """

    addr: int
    mask: int

    def __post_init__(self) -> None:
        if self.addr & self.mask:
            raise ValueError(
                f"address map base {self.addr:#x} not aligned to mask {self.mask:#x}"
            )

    def contains(self, address: int) -> bool:
        return (address & ~self.mask) == self.addr


def decode_match(req: MulticastRequest, am: AddressMap, addr_bits: int = ADDR_BITS) -> bool:
    """The paper's decoder condition, bit-for-bit.

    ``match = &((req.mask | am.mask) | ~(req.addr ^ am.addr))`` — the AND-
    reduction over ``addr_bits`` bits of (either bit is don't-care) OR (the
    address bits agree).
    """
    full = (1 << addr_bits) - 1
    dont_care = (req.mask | am.mask) & full
    agree = ~(req.addr ^ am.addr) & full
    return (dont_care | agree) == full


def matching_ports(
    req: MulticastRequest, address_maps: Sequence[AddressMap], addr_bits: int = ADDR_BITS
) -> List[int]:
    """Indices of every master port matched by a (possibly multicast) request."""
    return [i for i, am in enumerate(address_maps) if decode_match(req, am, addr_bits)]


# --- Cluster-selection layer (used by the offload runtime) ---------------------

def occamy_cluster_maps(num_clusters: int = NUM_CLUSTERS) -> List[AddressMap]:
    """One address map per cluster, stride 0x40000, as in Occamy."""
    stride_bits = CLUSTER_OFFSET_BITS
    return [
        AddressMap(addr=i << stride_bits, mask=(1 << stride_bits) - 1)
        for i in range(num_clusters)
    ]


def encode_cluster_selection(
    clusters: Iterable[int], num_clusters: int = NUM_CLUSTERS
) -> MulticastRequest:
    """Encode a set of cluster indices as a single multicast request.

    Only sets expressible as a subcube (base OR any subset of masked bits)
    can be encoded in one request; this mirrors the hardware, which sends one
    request per subcube.  Raises ``ValueError`` for non-subcube sets — the
    runtime then falls back to :func:`encode_cluster_selection_multi`.
    """
    cl = sorted(set(clusters))
    if not cl:
        raise ValueError("empty cluster selection")
    if cl[-1] >= num_clusters:
        raise ValueError(f"cluster index {cl[-1]} out of range ({num_clusters})")
    base = cl[0]
    # Bits that vary across the selection.
    varying = 0
    for c in cl:
        varying |= c ^ base
    base &= ~varying
    # The selection is a subcube iff every (base | subset(varying)) is present.
    expected = 1 << bin(varying).count("1")
    if expected != len(cl):
        raise ValueError(f"selection {cl} is not a subcube")
    covered = {base | s for s in _submasks(varying)}
    if covered != set(cl):
        raise ValueError(f"selection {cl} is not a subcube")
    return MulticastRequest(
        addr=base << CLUSTER_OFFSET_BITS, mask=varying << CLUSTER_OFFSET_BITS
    )


def encode_cluster_selection_multi(
    clusters: Iterable[int], num_clusters: int = NUM_CLUSTERS
) -> List[MulticastRequest]:
    """Greedy cover of an arbitrary cluster set by subcube multicast requests.

    The hardware can multicast any subcube in one transaction; arbitrary sets
    need several.  We greedily take the largest subcube fully contained in the
    remaining set (classical logic-minimization flavour; optimal covers are
    NP-hard and unnecessary here).
    """
    remaining = set(clusters)
    if not remaining:
        raise ValueError("empty cluster selection")
    if max(remaining) >= num_clusters:
        raise ValueError("cluster index out of range")
    idx_bits = max(1, (num_clusters - 1).bit_length())
    reqs: List[MulticastRequest] = []
    while remaining:
        best: Tuple[int, int] | None = None  # (base, varying)
        best_size = 0
        for base in sorted(remaining):
            for varying in _subcubes_at(base, idx_bits):
                size = 1 << bin(varying).count("1")
                if size <= best_size:
                    continue
                members = {(base & ~varying) | s for s in _submasks(varying)}
                if members <= remaining:
                    best = (base & ~varying, varying)
                    best_size = size
        assert best is not None  # singletons always qualify
        base, varying = best
        reqs.append(
            MulticastRequest(
                addr=base << CLUSTER_OFFSET_BITS, mask=varying << CLUSTER_OFFSET_BITS
            )
        )
        remaining -= {base | s for s in _submasks(varying)}
    return reqs


def decode_cluster_selection(
    req: MulticastRequest, num_clusters: int = NUM_CLUSTERS
) -> List[int]:
    """Which clusters does a request reach?  (Drives the runtime's device set.)"""
    maps = occamy_cluster_maps(num_clusters)
    return matching_ports(req, maps)


def encode_contiguous_window(
    start: int, n: int, num_clusters: int = NUM_CLUSTERS
) -> List[MulticastRequest]:
    """Encode the contiguous cluster window ``[start, start + n)``.

    The fabric scheduler's lease placement uses this as its *legality*
    contract: a window whose start is aligned to its (power-of-two) size is
    a single subcube and encodes as **one** multicast request — the paper's
    one-write wakeup stays O(1) for the whole lease.  Unaligned or
    non-power-of-two windows decompose greedily into the minimal aligned
    subcubes (binary buddy decomposition), so any contiguous lease is still
    addressable, just with more requests.
    """
    if n < 1:
        raise ValueError(f"window size must be >= 1, got {n}")
    if start < 0 or start + n > num_clusters:
        raise ValueError(
            f"window [{start}, {start + n}) outside [0, {num_clusters})")
    # a contiguous window is just a cluster set: the greedy subcube cover
    # already yields the buddy decomposition (one request per maximal
    # aligned power-of-two block, a single request for aligned windows)
    return encode_cluster_selection_multi(range(start, start + n),
                                          num_clusters)


def _submasks(mask: int) -> Iterator[int]:
    """All subsets of the set bits of ``mask`` (including 0 and mask)."""
    sub = mask
    while True:
        yield sub
        if sub == 0:
            return
        sub = (sub - 1) & mask


def _subcubes_at(base: int, idx_bits: int) -> Iterator[int]:
    """All 'varying' masks over idx_bits, largest-popcount candidates included."""
    for varying in range(1 << idx_bits):
        yield varying
