"""Distributed SELL-C-sigma SpMV (paper C4 + C5) over torch devices.

The port of ``repro.core.distributed``.  Row-wise, *weight-proportional*
distribution of the system matrix over shards (GHOST section 4.1,
Fig. 3), each shard on its own torch device, with the shard's rows split
into a **local** part (columns the shard owns) and a **remote** part
whose column indices are *compressed* into a dense halo buffer — the
paper's remote-column compression.

Where the JAX package runs one SPMD program under ``shard_map`` over
every device of its mesh, the port is one process that runs explicit
stages for every shard on that shard's device, in GHOST's task-mode
order (paper Fig. 5).  The shards may lie on any cards and on the host:

* **pack** — gather the owned rows each peer needs into the shard's
  block of its device's *staging stack*, ``stack[q][p]`` = what shard
  ``q`` sends shard ``p`` (``max_msg`` rows each, as the reference pads
  its messages; one zero row closes the stack);
* **exchange** — ``lax.all_to_all`` becomes the block copies
  ``recv[p][q] = send[q][p]`` of :func:`exchange_copies`, only the
  ``msg_len[q, p]`` rows ``q`` sends ``p``: between two shards on one
  device nothing moves (the unpack reads the sender's block in place);
  between two cards the block goes card to card (a peer copy where the
  cards reach each other, else staged by the CUDA runtime); between a
  card and the host it crosses as a ``non_blocking`` copy through pinned
  host staging;
* **unpack** — gather this shard's dense halo out of its device's stack;
* **local** / **remote** — kernel B1 on a card shard (the remote part is
  rectangular: its ``x`` is the halo, and it adds the local result as
  its ``y_in``), the plain version on a CPU shard;
* **epilogue** — shift, scale, axpby and the fused dots' partials in
  plain PyTorch, as in the reference (B1 refuses the shift and the
  x-dots on a rectangular part).  ``lax.psum`` becomes the sum of the
  float64 partials on the home device, in shard order.

**Streams.**  :func:`spmv_shard_stages` gives every card a side stream
(kept by :class:`Staging`) and its compute stream.  On each card's side
stream: wait on an event marking ``xs`` ready on its compute stream,
pack that card's shards, then the copies; the unpack follows on the
destination's side stream, and its remote SpMVs wait on its
"exchanged" event while its local SpMVs run on the compute stream.  A
copy between two cards runs on the *source* card's current stream with
a barrier against the destination's current stream (ATen's
device-to-device copy), so both cards' side streams are made current
around it; otherwise it would queue behind the source's local SpMV.  A
copy from the host runs on the destination card's side stream, one to
the host on the source card's.

**Layout.**  The reference pads every shard to the largest shard's
``m_pad`` and stacks them.  Here each shard keeps its own ``nrows_pad``
and the operator space is the shards' concatenation: ``g2l`` is per
shard and ``pos_of_global`` is ``offset_p + slot`` where the reference
has ``p * m_pad + slot``.  ``send_idx``, ``halo_idx``, ``max_msg``,
``h_max``, ``row_ranges`` and ``shard_nnz`` equal the reference's: none
depends on where a shard lives.  A CPU+GPU split gives the host a few
per cent of the rows; the reference's padding would give its shard as
many vector rows as the card's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import partition as part
from repro_torch.core.execution import canonical_device
from repro_torch.core.sellcs import SellCS, _np_dtype, from_coo
from repro_torch.core.spmv import SpmvOpts, as2d, fused_dots, spmv, x_rows

__all__ = [
    "DistShard", "DistSellCS", "Staging", "dist_from_coo", "dist_spmv",
    "make_dist_spmv", "exchange_copies", "halo_pack", "halo_exchange",
    "halo_unpack",
    "local_stage", "remote_stage", "fused_epilogue", "spmv_shard_stages",
    "dist_spmv_shard",
]


@dataclasses.dataclass(frozen=True, eq=False)
class DistShard:
    """One shard's parts and maps, every tensor on ``device``."""

    device: torch.device
    local: SellCS           # (m, m), shard-sigma-permuted columns
    remote: SellCS          # (m, max(h, 1)), halo columns, local's row perm
    send_idx: torch.Tensor  # (P*max_msg,) int64 local slots each peer needs
    halo_gidx: torch.Tensor  # (x_rows(remote),) int64 rows of the stack
    g2l: torch.Tensor       # (nrows_pad,) int64 global row per slot (-1 pad)
    offset: int             # first row of the shard in the operator space
    nhalo: int              # remote columns (h)

    @property
    def nrows_pad(self) -> int:
        return self.local.nrows_pad


def _sellcs_to(M: SellCS, device: torch.device) -> SellCS:
    moved = {f.name: getattr(M, f.name).to(device)
             for f in dataclasses.fields(M)
             if isinstance(getattr(M, f.name), torch.Tensor)}
    return dataclasses.replace(M, **moved)


@dataclasses.dataclass(frozen=True, eq=False)
class DistSellCS:
    """Row-distributed SELL-C-sigma matrix over ``nshards`` shards.

    The host-side maps (numpy) are the reference's, through the layout
    mapping of the module note; each shard's tensors live on its device.
    """

    shards: Tuple[DistShard, ...]
    # halo exchange maps, host-side (equal to the reference's)
    send_idx: np.ndarray       # (P, P, max_msg) gather into x_local [src][dst]
    halo_idx: np.ndarray       # (P, h_max) into the flattened receive buffer
    msg_len: np.ndarray        # (P, P) rows shard q sends shard p [src][dst]
    # vector distribution maps, host-side
    g2l: Tuple[np.ndarray, ...]   # per shard (nrows_pad_p,), -1 pad
    pos_of_global: np.ndarray  # (nrows,) into the operator space
    pos_t: torch.Tensor        # pos_of_global on the home device

    # partition bookkeeping (feeds the runtime's rebalance loop)
    row_ranges: Tuple[Tuple[int, int], ...]
    shard_nnz: Tuple[int, ...]

    nshards: int
    C: int
    sigma: int
    w_align: int
    nrows: int
    m_pad: int                 # the largest shard's nrows_pad
    max_msg: int
    h_max: int
    # compute (accumulation) dtype name when the value shards are stored
    # narrower; None = values are stored in the compute dtype
    compute_dtype: Optional[str] = None

    # ------------------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        """Compute dtype — accumulation, vectors, halo buffers."""
        return self.shards[0].local.dtype

    @property
    def store_dtype(self) -> torch.dtype:
        """Storage dtype of the local/remote value shards."""
        return self.shards[0].local.store_dtype

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(s.device for s in self.shards)

    @property
    def cards(self) -> Tuple[torch.device, ...]:
        """The shards' distinct CUDA devices, in shard order."""
        return _cards(self.devices)

    @property
    def home(self) -> torch.device:
        """Where solver vectors live: the first card in shard order, else
        the host."""
        return _home(self.devices)

    @functools.cached_property
    def copies(self) -> List[Tuple[int, int, int, int]]:
        """The halo exchange's block copies on this placement
        (:func:`exchange_copies` keyed by the shards' devices)."""
        return exchange_copies(self.msg_len, self.max_msg, self.devices)

    @property
    def n(self) -> int:
        """Rows of the operator space (the shards' nrows_pad summed)."""
        return sum(s.nrows_pad for s in self.shards)

    @property
    def has_halo(self) -> bool:
        return any(s.nhalo for s in self.shards)

    @property
    def comm_volume(self) -> int:
        """Worst-case halo words moved per shard per SpMV (padded)."""
        return self.nshards * self.max_msg

    def on(self, devices: Sequence) -> "DistSellCS":
        """The same matrix with shard ``p`` on ``devices[p]``."""
        devs = _check_devices(devices, self.nshards)
        if devs == self.devices:
            return self
        shards = tuple(dataclasses.replace(
            s, device=d, local=_sellcs_to(s.local, d),
            remote=_sellcs_to(s.remote, d), send_idx=s.send_idx.to(d),
            halo_gidx=s.halo_gidx.to(d), g2l=s.g2l.to(d))
            for s, d in zip(self.shards, devs))
        return dataclasses.replace(self, shards=shards,
                                   pos_t=self.pos_t.to(_home(devs)))

    # -------------------------------------------------------- vectors
    def distribute_vec(self, x) -> List[torch.Tensor]:
        """Global original-space ``(nrows[, b])`` -> per-shard permuted
        slices ``(nrows_pad_p[, b])``, each on its shard's device."""
        x = torch.as_tensor(x)
        out = []
        for s in self.shards:
            xv = x.to(s.device)[s.g2l.clamp(min=0)]
            xv[s.g2l < 0] = 0
            out.append(xv)
        return out

    def collect_vec(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-shard slices -> global original space, on the home device."""
        return self.join(xs)[self.pos_t]

    def split(self, v: torch.Tensor) -> List[torch.Tensor]:
        """An operator-space vector (on the home device) -> per-shard
        slices on the shards' devices (views where they coincide)."""
        return [v[s.offset:s.offset + s.nrows_pad].to(s.device)
                for s in self.shards]

    def join(self, vs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-shard slices -> one operator-space vector on the home
        device."""
        home = self.home
        return torch.cat([v.to(home) for v in vs])


def _cards(devs) -> Tuple[torch.device, ...]:
    return tuple(dict.fromkeys(d for d in devs if d.type == "cuda"))


def _home(devs) -> torch.device:
    cards = _cards(devs)
    return cards[0] if cards else torch.device("cpu")


def _check_devices(devices, nshards: int) -> Tuple[torch.device, ...]:
    devs = tuple(canonical_device(d) for d in devices)
    if len(devs) != nshards:
        raise ValueError(f"expected {nshards} devices, got {len(devs)}")
    return devs


def dist_from_coo(
    rows, cols, vals, nrows: int, *,
    nshards: int,
    devices: Optional[Sequence] = None,
    weights: Optional[Sequence[float]] = None,
    C: int = 32,
    sigma: int = 1,
    w_align: int = 1,
    by_nnz: bool = False,
    dtype=None,
    store_dtype=None,
    ranges: Optional[Sequence[Tuple[int, int]]] = None,
) -> DistSellCS:
    """Build a row-distributed SELL-C-sigma matrix from global COO (square).

    ``devices`` names one torch device per shard (``None``: every shard on
    the card, which raises without one).  ``ranges`` overrides the
    internal weighted partition with precomputed contiguous row ranges
    (e.g. from :func:`repro_torch.runtime.split.plan_split`).
    ``store_dtype`` keeps every shard's local *and* remote values in a
    narrower storage dtype; vectors and halos stay in the compute dtype.
    """
    devs = _check_devices([None] * nshards if devices is None else devices,
                          nshards)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    if dtype is not None:
        vals = vals.astype(_np_dtype(dtype), copy=False)
    weights = [1.0] * nshards if weights is None else list(weights)
    if len(weights) != nshards:
        raise ValueError(
            f"expected {nshards} weights, got {len(weights)}")

    if ranges is not None:
        ranges = [(int(s), int(e)) for (s, e) in ranges]
        if len(ranges) != nshards:
            raise ValueError(
                f"expected {nshards} ranges, got {len(ranges)}")
        if ranges[0][0] != 0 or ranges[-1][1] != nrows:
            raise ValueError(
                f"ranges must cover [0, {nrows}), got "
                f"[{ranges[0][0]}, {ranges[-1][1]})")
        if any(ranges[i][1] != ranges[i + 1][0]
               for i in range(nshards - 1)):
            raise ValueError("ranges must be contiguous (each end == "
                             "next start)")
    elif by_nnz:
        rowlen = np.zeros(nrows, np.int64)
        np.add.at(rowlen, rows, 1)
        ranges = part.weighted_nnz_partition(rowlen, weights, align=1)
    else:
        ranges = part.weighted_row_partition(nrows, weights, align=1)

    locals_: List[SellCS] = []
    remotes: List[SellCS] = []
    perms: List[np.ndarray] = []
    iperms: List[np.ndarray] = []
    rcols_all: List[np.ndarray] = []
    for (s, e), dev in zip(ranges, devs):
        m = e - s
        sel = (rows >= s) & (rows < e)
        r_p, c_p, v_p = rows[sel] - s, cols[sel], vals[sel]
        is_local = (c_p >= s) & (c_p < e)
        # local square part: shard-level sigma sorting + permuted columns
        # (dtype= keeps an empty part in the values' dtype)
        L = from_coo(r_p[is_local], c_p[is_local] - s, v_p[is_local],
                     (m, m), C=C, sigma=sigma, w_align=w_align,
                     dtype=vals.dtype, store_dtype=store_dtype, device=dev)
        perm = L.perm.cpu().numpy().astype(np.int64)
        # remote part: compressed halo columns, same row perm as local
        rg = c_p[~is_local]
        rcols = np.unique(rg)                          # sorted ascending
        hidx = np.searchsorted(rcols, rg)
        R = from_coo(r_p[~is_local], hidx, v_p[~is_local],
                     (m, max(len(rcols), 1)), C=C, sigma=1,
                     w_align=w_align, dtype=vals.dtype,
                     store_dtype=store_dtype,
                     row_perm=perm, permute_columns=False, device=dev)
        locals_.append(L)
        remotes.append(R)
        perms.append(perm)
        iperms.append(L.iperm.cpu().numpy().astype(np.int64))
        rcols_all.append(rcols)

    # ---- halo exchange maps (the reference's, entry for entry) ----------
    starts = np.array([s for (s, _) in ranges], np.int64)
    owner_of = np.zeros(nrows, np.int64)
    for q, (s, e) in enumerate(ranges):
        owner_of[s:e] = q
    send_lists = [[np.zeros(0, np.int64) for _ in range(nshards)]
                  for _ in range(nshards)]            # [src][dst]
    halo_entries = []                                  # per shard: (owner, rank)
    cnt = np.zeros((nshards, nshards), np.int64)       # cnt[src][dst]
    for p in range(nshards):
        rcols = rcols_all[p]
        owners = owner_of[rcols] if len(rcols) else np.zeros(0, np.int64)
        ent = np.zeros((len(rcols), 2), np.int64)
        for q in range(nshards):
            sel = owners == q
            g = rcols[sel]
            # owner-local (permuted) positions, ascending in g
            send_lists[q][p] = iperms[q][g - starts[q]]
            ent[sel, 0] = q
            ent[sel, 1] = np.arange(sel.sum())
            cnt[q, p] = sel.sum()
        halo_entries.append(ent)
    max_msg = max(1, int(cnt.max()))
    h_max = max(1, max(len(r) for r in rcols_all))

    send_idx = np.zeros((nshards, nshards, max_msg), np.int64)
    for q in range(nshards):
        for p in range(nshards):
            sl = send_lists[q][p]
            send_idx[q, p, : len(sl)] = sl
    halo_idx = np.zeros((nshards, h_max), np.int64)
    for p in range(nshards):
        ent = halo_entries[p]
        halo_idx[p, : len(ent)] = ent[:, 0] * max_msg + ent[:, 1]

    # ---- vector maps: each shard at its own nrows_pad --------------------
    offsets = np.concatenate(
        [[0], np.cumsum([L.nrows_pad for L in locals_])]).astype(np.int64)
    g2l: List[np.ndarray] = []
    pos_of_global = np.zeros(nrows, np.int64)
    for p, (s, e) in enumerate(ranges):
        permp = perms[p]
        # local permuted slot j holds original row s + permp[j] (if < m)
        valid = permp < e - s
        gp = np.full(len(permp), -1, np.int64)
        gp[valid] = s + permp[valid]
        g2l.append(gp)
        pos_of_global[s + permp[valid]] = offsets[p] + np.nonzero(valid)[0]

    # the stack's rows: [src q][dst p][rank], then one zero row
    zero_row = nshards * nshards * max_msg
    shards = []
    for p, dev in enumerate(devs):
        ent = halo_entries[p]
        gidx = np.full(x_rows(remotes[p]), zero_row, np.int64)
        gidx[: len(ent)] = ((ent[:, 0] * nshards + p) * max_msg
                            + ent[:, 1])
        shards.append(DistShard(
            device=dev, local=locals_[p], remote=remotes[p],
            send_idx=torch.from_numpy(send_idx[p].reshape(-1)).to(dev),
            halo_gidx=torch.from_numpy(gidx).to(dev),
            g2l=torch.from_numpy(g2l[p]).to(dev),
            offset=int(offsets[p]), nhalo=len(rcols_all[p])))
    home = _home(devs)
    return DistSellCS(
        shards=tuple(shards),
        send_idx=send_idx, halo_idx=halo_idx, msg_len=cnt,
        g2l=tuple(g2l), pos_of_global=pos_of_global,
        pos_t=torch.from_numpy(pos_of_global).to(home),
        row_ranges=tuple((int(s), int(e)) for (s, e) in ranges),
        shard_nnz=tuple(int(L.nnz + R.nnz)
                        for L, R in zip(locals_, remotes)),
        nshards=nshards, C=C, sigma=sigma, w_align=w_align, nrows=nrows,
        m_pad=max(L.nrows_pad for L in locals_), max_msg=max_msg,
        h_max=h_max, compute_dtype=locals_[0].compute_dtype,
    )


# ---------------------------------------------------------------------------
# Stages.  Each runs one shard's step on the current stream of that
# shard's device; spmv_shard_stages orders them and places the streams.
# ---------------------------------------------------------------------------

class Staging:
    """The halo staging of a chain of SpMVs: ``slots`` staging stacks on
    every device of ``A``, taken in turn, one per call, and one side
    stream per card.

    A stack is ``(P*P*max_msg + 1, b)``.  When a card and the host share
    the work, the host's stacks are pinned and the copies that read them
    run asynchronously: :meth:`take` waits, on the events the previous
    user of the slot left, until no copy reads the slot any more, so a
    slot is never rewritten while its copy is in flight.  With two slots
    that wait is for the call before last.  A card's stack needs no such
    wait: a copy that reads it runs on that card's side stream, ahead of
    the next pack there, and a copy into it waits, by the barrier every
    copy between two cards makes, for what the destination's side stream
    holds, the unpack that last read those rows included.
    """

    def __init__(self, A: DistSellCS, nvecs: int, dtype: torch.dtype,
                 slots: int = 1):
        rows = A.nshards * A.nshards * A.max_msg + 1
        cards = A.cards
        pin = bool(cards) and any(d.type == "cpu" for d in A.devices)
        self.stacks = [{d: torch.zeros((rows, nvecs), dtype=dtype, device=d,
                                       pin_memory=pin and d.type == "cpu")
                        for d in set(A.devices)} for _ in range(slots)]
        self.read_done: List[list] = [[] for _ in range(slots)]
        self.side = {c: torch.cuda.Stream(device=c) for c in cards}
        self.calls = 0

    @property
    def slots(self) -> int:
        return len(self.stacks)

    def take(self) -> int:
        """The next slot, once no copy reads its host stack any more."""
        slot = self.calls % self.slots
        self.calls += 1
        for ev in self.read_done[slot]:
            ev.synchronize()
        self.read_done[slot] = []
        return slot


def exchange_copies(msg_len, max_msg: int, keys: Sequence
                    ) -> List[Tuple[int, int, int, int]]:
    """The block copies of one halo exchange, ``recv[p][q] = send[q][p]``:
    ``(q, p, at, n)`` moves rows ``at:at + n`` of the stack on shard
    ``q``'s device into the same rows of the stack on shard ``p``'s, ``n``
    = ``msg_len[q, p]`` (the rows ``q`` sends ``p``, not the padded
    ``max_msg``).  ``keys[p]`` names shard ``p``'s device (anything that
    compares by value); a pair on one device, or with nothing to send,
    has no copy.  Ordered by destination, then source."""
    P = len(keys)
    return [(q, p, (q * P + p) * max_msg, int(msg_len[q, p]))
            for p in range(P) for q in range(P)
            if keys[q] != keys[p] and msg_len[q, p] > 0]


def halo_pack(A: DistSellCS, q: int, x_local: torch.Tensor,
              stack: torch.Tensor) -> None:
    """Stage 1: gather the owned rows each peer needs into shard ``q``'s
    block of its device's stack."""
    span = A.nshards * A.max_msg
    torch.index_select(x_local, 0, A.shards[q].send_idx,
                       out=stack[q * span:(q + 1) * span])


def halo_exchange(A: DistSellCS, p: int,
                  stacks: Dict[torch.device, torch.Tensor],
                  side: Optional[Dict[torch.device, torch.cuda.Stream]] = None
                  ) -> None:
    """Stage 2: the copies of :attr:`DistSellCS.copies` into shard ``p``,
    as ``non_blocking`` copies; shards on ``p``'s device need none.
    ``side`` maps each card to its side stream: the side streams of the
    cards at both ends are made current around a copy (one between two
    cards runs on the source's current stream, one from the host on the
    destination's, one to the host on the source's)."""
    dst = A.shards[p].device
    into = [(A.shards[q].device, at, n) for q, to, at, n in A.copies
            if to == p]
    for src, group in itertools.groupby(into, key=lambda c: c[0]):
        with contextlib.ExitStack() as streams:
            for d in (src, dst):
                if side and d in side:
                    streams.enter_context(torch.cuda.stream(side[d]))
            for _, at, n in group:
                stacks[dst][at:at + n].copy_(stacks[src][at:at + n],
                                             non_blocking=True)


def halo_unpack(A: DistSellCS, p: int, stack: torch.Tensor) -> torch.Tensor:
    """Stage 3: shard ``p``'s dense halo out of its device's stack
    (remote-column compression, Fig. 3)."""
    return torch.index_select(stack, 0, A.shards[p].halo_gidx)


def local_stage(A: DistSellCS, p: int, x_local: torch.Tensor, *,
                impl: Optional[str] = None) -> torch.Tensor:
    """Stage 4: SpMV of the local (square) part — no communication.
    The value shard streams at its storage dtype and accumulates in the
    compute dtype."""
    return spmv(A.shards[p].local, x_local, impl=impl)[0]


def remote_stage(A: DistSellCS, p: int, halo: torch.Tensor,
                 y_loc: torch.Tensor, *,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Stage 5: ``y_loc`` plus the remote part against the compressed
    halo, in one SpMV (``y_loc`` is its ``y_in``, beta 1).  A shard with
    no remote nonzeros launches nothing and returns ``y_loc``."""
    R = A.shards[p].remote
    if R.nnz == 0:
        return y_loc
    return spmv(R, halo, y_loc, opts=SpmvOpts(beta=1.0), impl=impl)[0]


def fused_epilogue(Ax: torch.Tensor, x_local: torch.Tensor,
                   opts: SpmvOpts, y_local: Optional[torch.Tensor] = None):
    """Stage 6: shift/scale/axpby, and this shard's float64 partials of
    the fused dots (None when none is asked for)."""
    dev = Ax.device

    def on(c):
        return c.to(dev) if isinstance(c, torch.Tensor) else c

    if opts.gamma is not None:
        gamma = torch.as_tensor(on(opts.gamma), dtype=Ax.dtype, device=dev)
        Ax = Ax - gamma * x_local.to(Ax.dtype)
    alpha = on(opts.alpha)
    # alpha == 1 as a number multiplies nothing: the product is exact
    y = Ax if isinstance(alpha, (int, float)) and alpha == 1 else alpha * Ax
    if y_local is not None:
        y = y + on(opts.beta) * y_local.to(y.dtype)
    dots = fused_dots(x_local, y, opts) if opts.any_dot else None
    return y, dots


def _elapsed(events) -> float:
    """Seconds between CUDA event pairs, summed (waits for them)."""
    return sum(a.elapsed_time(b) for a, b in events) / 1e3


def spmv_shard_stages(
    A: DistSellCS,
    xs: Sequence[torch.Tensor],
    *,
    overlap: bool = True,
    impl: Optional[str] = None,
    opts: SpmvOpts = SpmvOpts(),
    ys: Optional[Sequence[torch.Tensor]] = None,
    staging: Optional[Staging] = None,
    times: Optional[dict] = None,
):
    """Every shard's fused distributed SpMV step.  Returns
    ``(y_list, dots, staging)``: per-shard outputs on the shards'
    devices, and the ``(3, b)`` float64 dots summed on the home device in
    shard order (None when none is asked for).

    ``xs[p]`` is shard ``p``'s ``(nrows_pad_p, b)`` slice on its device.
    The host packs its shards first.  On each card, the pack, the copies
    that card's side stream carries (see the module note) and the unpack
    go on the staging's side stream, after an event that marks ``xs``
    ready on the compute stream; the copies to the host are enqueued
    first.  The local SpMVs run on each card's compute stream meanwhile
    (``overlap=True``) or after its exchange (``overlap=False``), and the
    remote SpMVs wait on the card's "exchanged" event.  Every card's work
    is enqueued before the host runs its own shards' stages, which wait
    for the copies to the host only before their unpack (or, without
    overlap, before their local stage).

    ``times``, when a dict, receives ``"shards"`` (seconds of each
    shard's stages: CUDA events around a card shard's, the host clock
    around a host shard's) and ``"transfer"`` (seconds from the end of
    each card's pack to the end of the copies on its side stream, summed
    over the cards); the call then waits for every card.
    """
    b = xs[0].shape[1]
    if staging is None:
        staging = Staging(A, b, xs[0].dtype)
    slot = staging.take()
    stacks = staging.stacks[slot]
    side = staging.side
    cards = A.cards
    on_card = {c: [p for p, s in enumerate(A.shards) if s.device == c]
               for c in cards}
    on_host = [p for p, s in enumerate(A.shards) if s.device.type == "cpu"]
    exchange = A.has_halo
    out: List[Optional[torch.Tensor]] = [None] * A.nshards
    dots: List[Optional[torch.Tensor]] = [None] * A.nshards
    y_loc: List[Optional[torch.Tensor]] = [None] * A.nshards
    halos: Dict[int, torch.Tensor] = {}
    card_ev: Dict[int, list] = {p: [] for c in cards for p in on_card[c]}
    copy_ev: Dict[torch.device, list] = {c: [] for c in cards}
    host_s = [0.0] * A.nshards

    def mark(stream, pairs):
        """Open (or close) a timed span on ``stream`` when timing."""
        if times is None:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        if pairs and len(pairs[-1]) == 1:
            pairs[-1] = (pairs[-1][0], ev)
        else:
            pairs.append((ev,))

    def finish(p, halo):
        Ax = (remote_stage(A, p, halo, y_loc[p], impl=impl)
              if exchange else y_loc[p])
        out[p], dots[p] = fused_epilogue(
            Ax, xs[p], opts, None if ys is None else ys[p])

    if exchange:
        for q in on_host:
            t0 = time.perf_counter()
            halo_pack(A, q, xs[q], stacks[xs[q].device])
            host_s[q] += time.perf_counter() - t0
    compute = {c: torch.cuda.current_stream(c) for c in cards}
    d2h_done: list = []
    exchanged = {}
    if exchange and cards:
        for c in cards:
            ready = compute[c].record_event()
            with torch.cuda.stream(side[c]):
                side[c].wait_event(ready)
                for q in on_card[c]:
                    xs[q].record_stream(side[c])
                    halo_pack(A, q, xs[q], stacks[c])
                mark(side[c], copy_ev[c])
        # the host's halo rows first: the host waits for nothing else
        for p in on_host:
            halo_exchange(A, p, stacks, side)
        if on_host:
            d2h_done = [side[c].record_event() for c in cards]
        for c in cards:
            with torch.cuda.stream(side[c]):
                for p in on_card[c]:
                    halo_exchange(A, p, stacks, side)
        for c in cards:
            with torch.cuda.stream(side[c]):
                mark(side[c], copy_ev[c])
                if on_host:
                    staging.read_done[slot].append(side[c].record_event())
                for p in on_card[c]:
                    halos[p] = halo_unpack(A, p, stacks[c])
                    halos[p].record_stream(compute[c])
                exchanged[c] = side[c].record_event()
    for c in cards:
        with torch.cuda.device(c):
            if exchange and not overlap:
                compute[c].wait_event(exchanged[c])
            for p in on_card[c]:
                mark(compute[c], card_ev[p])
                y_loc[p] = local_stage(A, p, xs[p], impl=impl)
                mark(compute[c], card_ev[p])
    for c in cards:
        with torch.cuda.device(c):
            if exchange and overlap:
                compute[c].wait_event(exchanged[c])
            for p in on_card[c]:
                mark(compute[c], card_ev[p])
                finish(p, halos.get(p))
                mark(compute[c], card_ev[p])
    # the host's shards, while the cards work; their halo rows from the
    # cards have landed once every d2h_done event has
    if on_host and not overlap:
        for ev in d2h_done:
            ev.synchronize()
    for p in on_host:
        t0 = time.perf_counter()
        y_loc[p] = local_stage(A, p, xs[p], impl=impl)
        host_s[p] += time.perf_counter() - t0
    for ev in d2h_done:
        ev.synchronize()
    for p in on_host:
        t0 = time.perf_counter()
        halo = (halo_unpack(A, p, stacks[xs[p].device]) if exchange
                else None)
        finish(p, halo)
        host_s[p] += time.perf_counter() - t0

    total = None
    if opts.any_dot:
        for d in dots:
            d = d.to(A.home)
            total = d if total is None else total + d
    if times is not None:
        for c in cards:
            torch.cuda.synchronize(c)
        times["shards"] = [_elapsed(card_ev[p]) if p in card_ev
                           else host_s[p] for p in range(A.nshards)]
        times["transfer"] = sum((_elapsed(copy_ev[c]) for c in cards), 0.0)
    return out, total, staging


def dist_spmv_shard(A: DistSellCS, xs: Sequence[torch.Tensor], **kw):
    """All shards' fused distributed SpMV step without kept staging.
    Returns ``(y_list, dots)``."""
    ys, dots, _ = spmv_shard_stages(A, xs, **kw)
    return ys, dots


def make_dist_spmv(
    A: DistSellCS,
    devices: Optional[Sequence] = None,
    *,
    overlap: bool = True,
    impl: Optional[str] = None,
    opts: SpmvOpts = SpmvOpts(),
    nvecs: int = 1,
) -> Callable[[Sequence[torch.Tensor]],
              Tuple[List[torch.Tensor], Optional[torch.Tensor]]]:
    """A distributed SpMV over per-shard vectors.

    ``devices`` (one torch device per shard) takes the place of the
    reference's mesh: the shards move there first if they lie elsewhere.
    The returned fn maps the per-shard slices (see
    :meth:`DistSellCS.distribute_vec`) to ``(y_list, dots)``.  It keeps
    one staging slot across calls.
    """
    if devices is not None:
        A = A.on(devices)
    staging = Staging(A, nvecs, A.dtype)

    def run(xs):
        ys, dots, _ = spmv_shard_stages(A, xs, overlap=overlap, impl=impl,
                                        opts=opts, staging=staging)
        return ys, dots

    run.A = A
    return run


def dist_spmv(A: DistSellCS, devices: Optional[Sequence], x, **kw):
    """Convenience: global original-space x -> global y (on the home
    device) and the dots."""
    x = torch.as_tensor(x)
    x2, was1d = as2d(x)
    run = make_dist_spmv(A, devices, nvecs=x2.shape[1], **kw)
    ys, dots = run(run.A.distribute_vec(x2))
    y = run.A.collect_vec(ys)
    return (y[:, 0] if was1d else y), dots
