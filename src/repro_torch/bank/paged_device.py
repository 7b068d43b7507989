"""PagedDeviceBank — a bounded pool of device pages behind a page table.

Counterpart of `repro/bank/paged_device.py`. The bank keeps `n_slots`
fixed-size pages of `page_size` rows per leaf on the device, plus one dummy
page, and addresses logical row `lid` through a page table:

    phys(lid) = page_table[lid // page_size] * page_size + lid % page_size

So device memory is (n_slots+1)·page_size rows per leaf whatever N is: at
paper_mlp's width (d = 50,698) and N = 10⁶ a dense bank would need 202.8 GB,
a `PagedDeviceBank(page_size=8, n_slots=256)` holds 416,940,352 B of pages
and spills the rest to host memory.

Residency is managed on the host by `prepare(state, ids)`, which the runner
calls before each cohort round (and `scatter` calls again): it pages the
cohort's logical pages in, evicting deterministic-LRU victims (the oldest
stamp, ties by page id) to a host spill store. Evicted pages leave the card
in one `index_select` and one copy to the host per leaf; pages faulted back
from the spill store go up in one `index_copy_` per leaf; pages never
written are zeroed in place on the device (one `index_fill_` per leaf), so
a slot never shows a former tenant's rows. When the pages are on the card
the spill store is pinned memory: evictions copy into pinned blocks and
page-ins stage their pages in a pinned buffer, so both copies are DMA.

Why paging never changes the numbers: a gather returns the same values
whatever slot a row occupies, and the delta sum runs over the cohort axis,
never over physical rows. The scatter goes through `paged_bank_scatter`
(one launch for the tree), whose CUDA kernel shares its body and so its
summation order (`csrc/scatter_tree.cuh`) with the dense bank's
`bank_scatter`: on the card a paged trajectory is bit-equal to a dense
one, as long as every row a round touches is resident (`scatter` checks
this on the host mirror and raises otherwise).

State layout (tensors on the bank's device):
    pages      : tree, leaves ((n_slots+1)·page_size, *shape) `dtype`; the
                 last page is the dummy page, exact zeros, which pad slots
                 and non-resident reads resolve to.
    page_table : (logical_pages+1,) int32; the sentinel (= n_slots, the
                 dummy slot) marks non-resident pages; the last entry is the
                 dummy logical page, pinned to the dummy slot.
    g_sum      : tree, leaves (*shape,) f32 — running Σ_i G^i.

Host bookkeeping: a numpy mirror of the page table, a slot → logical page
map, the free list (popped 0, 1, 2, …), LRU stamps, and the spill store
{logical page: per-leaf host tensors (page_size, *shape), pinned on the
card}.

Fleets: a fleet state stacks K trials' states, so pages leaves are
(K, R, *shape), g_sum (K, *shape) and the page table (K, P), K identical
copies of one table. All trials share one residency map (this object's
host bookkeeping): `prepare` faults in the union of the trials' cohorts,
evicts and pages in along axis 1, and a spill block holds the page of
every trial, (K, page_size, *shape). `scatter_fleet` goes through the
batched kernel, one launch for every leaf and all K trials.

int8 pages (`dtype="int8"`, as the reference's): int8 rows plus an f32
absmax scale per physical row and leaf (`state["scales"]`, leaves (R,)),
stochastically rounded by `core.quantized_memory` from the generator passed
as `rng=` (the run's device generator: `round_rng = "device"`); G_sum is
kept over the dequantized values, so G_sum = Σ_i dequant(row_i). Plain
tensor ops on both devices, as the reference's int8 path takes no Pallas
kernel; the scatter and gather kernels stay with f32 and bf16 pages. Pages
spill and come back with their scales.

Staged scatter: `stage_rows` maps the padded cohort to sanitized logical
rows (int32; pad ids go to the dummy logical row) on the host, and
`scatter_staged` runs the kernel (or the int8 ops) on them, reading
nothing back to the host; the caller has paged the cohort in. Within a
chunk of the scan engine the page table is fixed, so the chunk's logical
rows are staged once with its other inputs.

Snapshots (`host_state` / `load_host_state`, for `checkpoint.save_run`):
the device state rides the run's snapshot in `runner.state`; `host_state`
adds the host bookkeeping under the reference's keys (the page-table
mirror, slot owners, the free list in order, LRU stamps, counters and every
spilled page as ``{"pages": [...], "scales": [...]}``), so a restored bank
pages exactly as the uninterrupted one. Spill blocks may still be filling
from the card, so `host_state` synchronises first; `load_host_state` puts
them back into pinned memory on the card.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.bank.base import (MemoryBank, check_row_range,
                                   host_cohort, tree_nbytes)
from repro_torch.checkpoint.io import bf16_tensor
from repro_torch.core import quantized_memory as qm
from repro_torch.kernels.backend import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.ops import (fleet_paged_bank_update_tree,
                                     paged_bank_gather_tree,
                                     paged_bank_update_tree)
from repro_torch.kernels.paged_bank import phys_rows
from repro_torch.tree import tree_index, tree_leaves, tree_map

# Profiler range around a fault's page-in (evictions to the host, uploads,
# the page-table update); `scripts/profile_round.py` reads it. With no
# profiler active it costs one small host call per faulting round.
PAGE_IN_RANGE = "bank.page_in"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class PagedDeviceBank(MemoryBank):
    """Bounded device memory behind a page table; see the module docstring.

    page_size : rows per page (a power of two).
    n_slots   : device pages resident at once (None => enough for all of N,
                i.e. fully resident).
    dtype     : "float32" | "bfloat16" | "int8" (int8 rows with per-row
                absmax scales, stochastic rounding).
    device    : where the pages live ("cuda" by default; "cpu" runs the
                kernels' plain versions).
    """

    def __init__(self, *, page_size: int = 64, n_slots: int | None = None,
                 dtype: str = "float32",
                 device: str | torch.device = DEFAULT_DEVICE):
        if page_size <= 0 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got "
                             f"{page_size}")
        if n_slots is not None and n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"unsupported bank dtype {dtype!r}")
        self.quantized = dtype == "int8"
        self.round_rng = "device" if self.quantized else "cpu"
        self.page_size = page_size
        self._n_slots_cfg = n_slots
        self.dtype = getattr(torch, dtype)
        self.device = resolve_device(device)
        self.n = 0
        self.n_slots = 0
        self.lp = 0            # logical pages holding real rows
        self.dummy_lrow = 0    # logical row that pad slots are remapped to
        self.sentinel = 0      # page-table value meaning "not resident"
        self._pt = np.zeros(0, np.int32)     # mirror of state["page_table"]
        self._slot_lp = np.zeros(0, np.int64)
        self._free: list[int] = []
        self._lru: dict[int, int] = {}
        self._clock = 0
        self._spill: dict[int, list[torch.Tensor]] = {}
        self._n_leaves = 0     # page leaves (a spill block's first entries)
        self.faults = 0
        self.evictions = 0
        self.refaults = 0      # faults served from the spill store

    def init(self, params, n_clients: int) -> dict:
        for p in tree_leaves(params):
            if p.device.type != self.device.type:
                raise ValueError(f"params on {p.device}, bank on "
                                 f"{self.device}: pass the run's device to "
                                 "PagedDeviceBank(device=...)")
        ps = self.page_size
        self.n = n_clients
        self.lp = -(-n_clients // ps)
        self.n_slots = (self.lp if self._n_slots_cfg is None
                        else self._n_slots_cfg)
        self.dummy_lrow = self.lp * ps
        self.sentinel = self.n_slots         # the dummy slot doubles as it
        n_rows = (self.n_slots + 1) * ps
        self._pt = np.full(self.lp + 1, self.sentinel, np.int32)
        self._pt[self.lp] = self.n_slots     # dummy logical page, pinned
        self._slot_lp = np.full(self.n_slots, -1, np.int64)
        self._free = list(range(self.n_slots - 1, -1, -1))   # pop() -> 0,1,..
        self._lru = {}
        self._clock = 0
        self._spill = {}
        self._n_leaves = len(tree_leaves(params))
        self.faults = self.evictions = self.refaults = 0
        state = {
            "pages": tree_map(lambda p: torch.zeros(
                (n_rows,) + tuple(p.shape), dtype=self.dtype,
                device=self.device), params),
            "page_table": torch.tensor(self._pt, device=self.device),
            "g_sum": tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=self.device), params),
        }
        if self.quantized:
            state["scales"] = tree_map(lambda p: torch.zeros(
                n_rows, dtype=torch.float32, device=self.device), params)
        return state

    def _row_leaves(self, state: dict) -> list[torch.Tensor]:
        """Every tensor with a physical-row axis: the page leaves, then
        (int8 pages) their scales; a spill block holds one per entry."""
        leaves = tree_leaves(state["pages"])
        if self.quantized:
            leaves += tree_leaves(state["scales"])
        return leaves

    # ------------------------------------------------------------------ #
    # residency: host bookkeeping, then a few batched device copies
    # ------------------------------------------------------------------ #

    @staticmethod
    def _is_fleet(state: dict) -> bool:
        return state["page_table"].ndim == 2

    def _page_rows(self, slots) -> torch.Tensor:
        ps = self.page_size
        rows = np.concatenate([np.arange(s * ps, (s + 1) * ps)
                               for s in slots])
        return torch.from_numpy(rows).to(self.device)

    def prepare(self, state: dict, ids) -> dict:
        """Make every logical page that `ids` touches device-resident.

        Evicts deterministic-LRU victims to the spill store and brings the
        faulted pages in (spilled data, or zeros for pages never written).
        Updates the state's tensors in place and returns the state. Raises
        when the working set cannot fit in `n_slots`. For a fleet state
        `ids` are the union of the trials' cohorts.
        """
        ps = self.page_size
        ids = np.asarray(ids, np.int64).reshape(-1)
        ids = ids[(ids >= 0) & (ids < self.n)]
        need = np.unique(ids // ps)
        if len(need) > self.n_slots:
            raise ValueError(
                f"cohort working set spans {len(need)} pages but "
                f"PagedDeviceBank has only {self.n_slots} slots "
                f"(page_size={ps}); raise n_slots or lower page_size")
        self._clock += 1
        for lp in need:
            self._lru[int(lp)] = self._clock
        missing = [int(lp) for lp in need if self._pt[lp] == self.sentinel]
        if missing:
            self.faults += len(missing)
            with record_function(PAGE_IN_RANGE):
                self._page_in(state, need, missing)
        return state

    def _page_in(self, state: dict, need: np.ndarray,
                 missing: list[int]) -> None:
        """Bring the `missing` pages of the working set `need` in."""
        ps = self.page_size
        # 1) host bookkeeping: a slot per faulted page, evicting the
        #    deterministic-LRU victim (oldest stamp, ties by page id) when
        #    the free list is empty
        needset = {int(lp) for lp in need}
        assign: list[tuple[int, int]] = []   # (lp, slot)
        evict: list[tuple[int, int]] = []    # (victim lp, slot)
        for lp in missing:
            if self._free:
                slot = self._free.pop()
            else:
                cands = [(t, v) for v, t in self._lru.items()
                         if self._pt[v] != self.sentinel and v not in needset]
                if not cands:
                    raise ValueError(
                        "no evictable page — all resident pages are in the "
                        "current working set (internal invariant violation)")
                _, victim = min(cands)
                slot = int(self._pt[victim])
                evict.append((victim, slot))
                self._pt[victim] = self.sentinel
                self._slot_lp[slot] = -1
                del self._lru[victim]
                self.evictions += 1
            assign.append((lp, slot))

        leaves = self._row_leaves(state)
        ax = 1 if self._is_fleet(state) else 0     # the row axis
        # 2) evicted pages to the host: one gather and one copy per leaf
        if evict:
            rows = self._page_rows(s for _, s in evict)
            host = [self._to_host(leaf.index_select(ax, rows))
                    for leaf in leaves]
            for k, (victim, _) in enumerate(evict):
                self._spill[victim] = [self._to_host(h.narrow(ax, k * ps, ps))
                                       for h in host]

        # 3) faulted pages in: spilled data goes up with one index_copy_
        #    per leaf; pages never written are zeroed on the device, which
        #    is REQUIRED, since the slot may hold an evicted page's rows
        spilled = {lp: self._spill.pop(lp) for lp, _ in assign
                   if lp in self._spill}
        self.refaults += len(spilled)
        fresh = [s for lp, s in assign if lp not in spilled]
        if fresh:
            rows = self._page_rows(fresh)
            for leaf in leaves:
                leaf.index_fill_(ax, rows, 0)
        back = [(lp, s) for lp, s in assign if lp in spilled]
        if back:
            rows = self._page_rows(s for _, s in back)
            for j, leaf in enumerate(leaves):
                blocks = [spilled[lp][j] for lp, _ in back]
                shape = list(blocks[0].shape)
                shape[ax] = sum(b.shape[ax] for b in blocks)
                vals = torch.empty(shape, dtype=blocks[0].dtype,
                                   pin_memory=self._pinned)
                torch.cat(blocks, dim=ax, out=vals)
                leaf.index_copy_(ax, rows,
                                 vals.to(self.device, non_blocking=True))

        # 4) the page table: the mirror, then the changed entries on device
        #    (in every trial's copy of a fleet's table)
        for lp, slot in assign:
            self._pt[lp] = slot
            self._slot_lp[slot] = lp
        changed = np.asarray([v for v, _ in evict] + [lp for lp, _ in assign],
                             np.int64)
        state["page_table"][..., torch.from_numpy(changed).to(
            self.device)] = torch.from_numpy(self._pt[changed]).to(
                self.device)

    @property
    def _pinned(self) -> bool:
        return self.device.type == "cuda"

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of `t` in host memory, pinned when the pages are on the
        card (the spill store's blocks and staging buffers)."""
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=self._pinned)
        out.copy_(t)
        return out

    # ------------------------------------------------------------------ #
    def _lids(self, ids: np.ndarray) -> np.ndarray:
        """Logical rows for the kernels: pad ids (>= N) go to the dummy
        logical row, which sits in the dummy page."""
        return np.where(ids >= self.n, self.dummy_lrow, ids).astype(np.int32)

    def stage_rows(self, ids: np.ndarray, valid: np.ndarray) -> np.ndarray:
        check_row_range(ids, valid, self.n)
        return self._lids(ids)

    def gather(self, state: dict, ids):
        return self._gather(state, ids)

    def _gather_trial(self, state: dict, k: int, ids):
        return self._gather(tree_index(state, k), ids, trial=k)

    def _gather(self, state: dict, ids, trial: int | None = None):
        """Rows `ids` of a single-trial state; `trial` is the state's slot
        in a fleet, whose spill blocks hold every trial's page."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and ids.min() < 0:
            raise IndexError(f"bank row ids must be >= 0, got {ids.min()}")
        lids = torch.from_numpy(self._lids(ids)).to(self.device)
        if self.quantized:
            phys = phys_rows(state["page_table"], lids, self.page_size)
            out = tree_map(lambda r, sc: qm.dequantize_leaf(r[phys],
                                                            sc[phys]),
                           state["pages"], state["scales"])
        else:
            out = paged_bank_gather_tree(state["pages"], state["page_table"],
                                         lids, page_size=self.page_size)
        # rows whose page lives in the spill store read the dummy page's
        # zeros on the device; patch them from the host
        ps = self.page_size
        pos = np.flatnonzero((ids < self.n)
                             & np.isin(ids // ps, list(self._spill)))
        if pos.size:
            pos_t = torch.from_numpy(pos).to(self.device)
            n_leaves = len(tree_leaves(out))

            def host_rows(j):
                blocks = [self._spill[int(ids[c] // ps)][j] for c in pos]
                if trial is not None:
                    blocks = [b[trial] for b in blocks]
                return torch.stack([b[int(ids[c] % ps)]
                                    for b, c in zip(blocks, pos)])

            for j, leaf in enumerate(tree_leaves(out)):
                rows = host_rows(j)
                if self.quantized:
                    rows = qm.dequantize_leaf(rows, host_rows(n_leaves + j))
                leaf.index_copy_(0, pos_t,
                                 rows.to(self.device, torch.float32))
        return out

    def _scatter_rows(self, state: dict, ids, updates, *, valid,
                      rng=None) -> dict:
        """Page the cohort in (for a fleet, the union of the trials'),
        check it on the host mirror, then scatter the staged cohort."""
        ids, valid = host_cohort(ids, valid)
        lids = self.stage_rows(ids, valid)
        state = self.prepare(state, ids[valid])
        # a valid row whose page is not resident would land in the dummy
        # page; the kernels do not check, so check the mirror here (O(C))
        if (self._pt[ids[valid] // self.page_size] == self.sentinel).any():
            raise RuntimeError("a valid cohort row's page is not resident "
                               "after prepare (page-table invariant broken)")
        lids, valid_t = self.upload(lids, valid)
        scatter = (self.scatter_fleet_staged if self._is_fleet(state)
                   else self.scatter_staged)
        return scatter(state, lids, valid_t, updates, rng=rng)

    _scatter_fleet_rows = _scatter_rows

    def scatter_staged(self, state: dict, rows: torch.Tensor,
                       valid: torch.Tensor, updates, *, rng=None) -> dict:
        if self.quantized:
            return self._scatter_int8(state, rows, valid, updates, rng)
        pages, dsum = paged_bank_update_tree(
            state["pages"], updates, state["page_table"], rows, valid,
            page_size=self.page_size)
        return {"pages": pages, "page_table": state["page_table"],
                "g_sum": tree_map(torch.add, state["g_sum"], dsum)}

    def scatter_fleet_staged(self, state: dict, rows: torch.Tensor,
                             valid: torch.Tensor, updates, *,
                             rng=None) -> dict:
        if self.quantized:
            if rng is None or len(rng) != rows.shape[0]:
                raise ValueError("int8 pages need one generator per trial "
                                 "(rng=[...]) for their rounding")
            for k, gen in enumerate(rng):
                self._scatter_int8(tree_index(state, k), rows[k], valid[k],
                                   tree_index(updates, k), gen)
            return state
        pages, dsum = fleet_paged_bank_update_tree(
            state["pages"], updates, state["page_table"], rows, valid,
            page_size=self.page_size)
        return {"pages": pages, "page_table": state["page_table"],
                "g_sum": tree_map(torch.add, state["g_sum"], dsum)}

    def _scatter_int8(self, state: dict, lids: torch.Tensor,
                      valid: torch.Tensor, updates, gen) -> dict:
        """The int8 scatter, in place on `state`'s tensors (so a trial's
        views of a fleet state update the stack): each cohort row is
        quantized with its own absmax scale; valid rows replace their
        stored row and scale, and G_sum moves by Σ (dequant(new) −
        dequant(old)). Pad slots all point at the dummy row and write its
        own zeros back."""
        if gen is None:
            raise ValueError("int8 pages need the run's device generator "
                             "(rng=) for their rounding")
        phys = phys_rows(state["page_table"], lids, self.page_size)

        def one(pages, scales, g_sum, u):
            q, s = qm.quantize_leaf(gen, u)
            old_q, old_s = pages[phys], scales[phys]
            vb = valid.reshape((-1,) + (1,) * (u.ndim - 1))
            delta = torch.where(vb, qm.dequantize_leaf(q, s)
                                - qm.dequantize_leaf(old_q, old_s), 0.0)
            pages.index_copy_(0, phys, torch.where(vb, q, old_q))
            scales.index_copy_(0, phys, torch.where(valid, s, old_s))
            g_sum.add_(delta.sum(0))

        tree_map(one, state["pages"], state["scales"], state["g_sum"],
                 updates)
        return state

    def host_state(self) -> dict:
        """The host bookkeeping for a run snapshot, under the reference's
        keys: the page-table mirror, slot owners, the free list IN ORDER
        (slot assignment order is part of the trajectory), LRU stamps,
        counters and every spilled page's blocks (pinned host tensors, not
        copies). Waits for the card first: an eviction's copy to the host
        may still be running."""
        if self._pinned:
            torch.cuda.synchronize(self.device)
        lps = sorted(self._spill)
        keys = sorted(self._lru)
        tree = {
            "pt": self._pt.copy(), "slot_lp": self._slot_lp.copy(),
            "free": np.asarray(self._free, np.int64),
            "lru_keys": np.asarray(keys, np.int64),
            "lru_vals": np.asarray([self._lru[k] for k in keys], np.int64),
            "clock": np.int64(self._clock),
            "faults": np.int64(self.faults),
            "evictions": np.int64(self.evictions),
            "spill_lp": np.asarray(lps, np.int64),
        }
        if lps:
            n = self._n_leaves
            tree["spill"] = [
                {"pages": self._spill[lp][:n], "scales": self._spill[lp][n:]}
                if self.quantized else {"pages": self._spill[lp]}
                for lp in lps]
        return tree

    def load_host_state(self, tree: dict) -> None:
        """Restore `host_state` bookkeeping (after `init`, before the
        first round). Spilled blocks, numpy (bf16 pages as their uint16
        bits) or tensors, go back into host memory, pinned on the card:
        each row leaf's blocks into one host buffer (one allocation, not
        one a page), whose views the spill store holds."""
        if not tree:
            return
        self._pt = np.asarray(tree["pt"], np.int32).copy()
        self._slot_lp = np.asarray(tree["slot_lp"], np.int64).copy()
        self._free = [int(s) for s in np.asarray(tree["free"])]
        self._lru = {int(k): int(v) for k, v in
                     zip(np.asarray(tree["lru_keys"]),
                         np.asarray(tree["lru_vals"]))}
        self._clock = int(tree["clock"])
        self.faults = int(tree["faults"])
        self.evictions = int(tree["evictions"])

        def block(a, dtype):
            if isinstance(a, torch.Tensor):
                t = a
            elif dtype == torch.bfloat16:
                t = bf16_tensor(np.asarray(a))
            else:
                t = torch.from_numpy(np.asarray(a, order="C"))
            if t.dtype != dtype:
                raise ValueError(f"spilled block of {t.dtype}, the bank "
                                 f"holds {dtype}")
            return t

        lps = [int(lp) for lp in np.asarray(tree["spill_lp"], np.int64)]
        entries = [[block(p, self.dtype) for p in e["pages"]]
                   + ([block(c, torch.float32) for c in e["scales"]]
                      if self.quantized else [])
                   for e in tree.get("spill", [])]
        self._spill = {lp: [] for lp in lps}
        for j in range(len(entries[0]) if entries else 0):
            col = [e[j] for e in entries]
            slab = torch.empty(sum(b.numel() for b in col),
                               dtype=col[0].dtype, pin_memory=self._pinned)
            for lp, b, part in zip(lps, col, slab.split(
                    [b.numel() for b in col])):
                part.copy_(b.reshape(-1))
                self._spill[lp].append(part.view(b.shape))

    def mean_g(self, state: dict):
        return tree_map(lambda g: g / self.n, state["g_sum"])

    # ------------------------------------------------------------------ #
    def n_resident(self) -> int:
        return int((self._pt[:self.lp] != self.sentinel).sum())

    def memory_bytes(self, state: dict) -> dict:
        """{'device', 'host', 'device_pages'}: device_pages is the bounded
        page pool, (n_slots+1)·page_size rows per leaf (with their scales
        for int8 pages), independent of N."""
        pages_b = tree_nbytes(self._row_leaves(state))
        dev = (pages_b + tree_nbytes(state["page_table"])
               + tree_nbytes(state["g_sum"]))
        host = sum(t.numel() * t.element_size()
                   for blocks in self._spill.values() for t in blocks)
        return {"device": dev, "host": host, "device_pages": pages_b}

    def check_invariants(self, state: dict | None = None) -> None:
        """Page-table invariants: no aliased slots, free-list conservation,
        mirror consistency, no page both resident and spilled; with `state`,
        also that the device table matches the mirror and the dummy page is
        exact zeros (for a fleet state, that every trial's copy of the table
        is the mirror). Raises AssertionError on the first one broken."""
        resident = {int(lp): int(s) for lp, s in enumerate(self._pt[:self.lp])
                    if s != self.sentinel}
        slots = list(resident.values())
        _require(len(slots) == len(set(slots)), "aliased physical slots")
        _require(all(0 <= s < self.n_slots for s in slots),
                 "slot out of range")
        _require(int(self._pt[self.lp]) == self.n_slots,
                 "dummy page unpinned")
        _require(len(self._free) + len(resident) == self.n_slots,
                 "free-list conservation violated")
        _require(set(self._free).isdisjoint(slots),
                 "slot both free and mapped")
        for lp, s in resident.items():
            _require(int(self._slot_lp[s]) == lp, "slot->page mirror drifted")
        for s in self._free:
            _require(int(self._slot_lp[s]) == -1, "free slot still mapped")
        _require(set(self._spill).isdisjoint(resident),
                 "page both resident and spilled")
        if state is not None:
            fleet = self._is_fleet(state)
            pt = state["page_table"].cpu().numpy()
            if fleet:
                _require(bool((pt == pt[0]).all()),
                         "fleet page tables diverged")
                pt = pt[0]
            _require(bool((pt == self._pt).all()),
                     "device page table != host mirror")
            start = self.n_slots * self.page_size
            for leaf in self._row_leaves(state):
                dummy = leaf[:, start:] if fleet else leaf[start:]
                _require(not dummy.any(), "dummy page not zero")
