"""PLONK circuits: kimchi-style gates, the 7-column permutation and lookups.

Counterpart of mina_bridge_tpu/kimchi/circuit.py: the constants the
verifier needs (COLUMNS, PERMUTS, COEFFS, ZK_ROWS, `gate_ctx`), the
coset `shifts`, the fixed `Circuit` (per-row gate kind, coefficients,
wiring, lookup tables) and the `CircuitBuilder` with its generic,
poseidon, EC, endo, xor, range and runtime-lookup rows. The builder is
the JAX package's, line for line, on Python ints.

Two differences, same results: the circuit's columns as REP tensors on
a device (`Circuit.tensors`, cached per device, with the sigma columns
of `sigma_evals_t`) replace its Python `sigma_evals` and interpolations
(`coeff_coeffs`, `sel_coeffs`; the prover's setup interpolates on its
device), and `check_witness` evaluates every gate over all rows at once
with the tensor FieldOps of kimchi/prover_vec.py where the JAX package
loops over the rows in Python.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..fields import ffl
from ..fields.params import FieldSpec
from ..hash.poseidon_params import WIDTH, poseidon_spec
from . import gates as G
from .domain import Domain

COLUMNS = 15  # kimchi register count
PERMUTS = 7  # columns under copy constraints
COEFFS = 15  # coefficient columns
ZK_ROWS = 3  # last rows: random witness/z values
# rows a block of the row-wise tensor evaluations (check_witness and the
# prover's quotient) holds at once: it bounds the constraint expressions'
# temporaries (up to about 200 live (rows, 22) int64 tensors, 9.2 GB at
# 2^18 rows) whatever the domain, so the 2^21-row coset of a 2^18 step
# circuit is evaluated in 8 blocks beside its 23 GB of extended columns.
ROW_BLOCK = 1 << 18


@functools.cache
def gate_ctx(field: FieldSpec) -> G.GateCtx:
    """Gate-evaluation context for circuits over `field`: poseidon spec plus
    the endo coefficient of the curve whose coordinates live in `field`."""
    from ..curves.host import PALLAS, VESTA

    emb = PALLAS if field.name == "fp" else VESTA
    assert emb.base.p == field.p
    return G.GateCtx(ps=poseidon_spec(field.name), endo=emb.endo_base, p=field.p)


@functools.cache
def shifts(field: FieldSpec, log_size: int) -> tuple[int, ...]:
    """Multiplicative coset shifts k_0=1, k_1..k_6 with pairwise-distinct
    cosets k_i * H (verified: (k_i/k_j)^n != 1)."""
    n = 1 << log_size
    p = field.p
    out = [1]
    cand = 2
    while len(out) < PERMUTS:
        ok = all(
            pow(cand * pow(k, p - 2, p) % p, n, p) != 1 for k in out
        ) and pow(cand, n, p) != 1
        if ok:
            out.append(cand)
        cand += 1
    return tuple(out)


@dataclasses.dataclass
class Circuit:
    """Fixed circuit: per-row gate kind + coefficients + wiring + lookups.

    wiring[(col, row)] = (col', row') — the permutation sends each cell of
    the first PERMUTS columns to the next cell in its copy-cycle.

    Lookups (kimchi-shape, always structurally present): JOINT_WIDTH-wide
    tables with ids, joint-combined per row with the transcript's joint
    combiner; up to LOOKUPS_PER_ROW queries per row, selected by the
    disjoint pattern selectors (legacy q_lookup, xor, rangecheck,
    lookup_rt — see gates.lookup_queries). The primary table (id 0)
    contains the all-zero dummy row. `rt_size` reserves runtime-table
    rows whose col1 values are supplied by the prover at proving time.
    """

    domain: Domain
    npub: int
    coeffs: list[list[int]]  # [COEFFS][n]
    sel: dict[str, list[int]]  # gate name -> 0/1 per row
    wiring: dict
    lookup_table: list[int] = dataclasses.field(default_factory=lambda: [0])
    q_lookup: list[int] = dataclasses.field(default_factory=list)
    xor_bits: int = 0  # xor-table nibble width (0 = table absent)
    range_bits: int = 0  # range-table limb width (0 = table absent)
    rt_size: int = 0  # runtime-table rows (0 = table absent)

    @property
    def n(self) -> int:
        return self.domain.n

    def sigma_evals_t(self, device) -> torch.Tensor:
        """The permutation's sigma columns on H as (PERMUTS, n, 22) REP on
        `device`: k_c omega^r in cell (c, r), each wired cell taking its
        successor's value (the shifts times the powers of omega, then the
        wiring as one gather)."""
        fs = self.domain.field
        n = self.n
        ks = shifts(fs, self.domain.log_size)
        pw = ffl.geometric(fs, 1, self.domain.omega, n, device)
        base = ffl.mul(fs, pw, ffl.from_ints(fs, ks, device)[:PERMUTS, None])  # (PERMUTS, n, 22)
        if not self.wiring:
            return base
        flat = base.reshape(PERMUTS * n, ffl.REP_LIMBS).clone()
        src = torch.as_tensor([c * n + r for (c, r) in self.wiring], device=device)
        dst = torch.as_tensor([c * n + r for (c, r) in self.wiring.values()], device=device)
        flat[src] = flat[dst].clone()
        return flat.reshape(PERMUTS, n, ffl.REP_LIMBS)

    def table_rows(self) -> list[tuple[int, int, int, int]]:
        """All fixed table rows as (col0, col1, col2, id) tuples, in
        committed order: primary, xor, range, runtime-index, zero pad.
        Runtime rows carry col1 = 0 — the prover's rt poly supplies it."""
        rows = [(v, 0, 0, G.TABLE_ID_PRIMARY) for v in sorted(self.lookup_table)]
        if self.xor_bits:
            w = 1 << self.xor_bits
            rows += [
                (a, b, a ^ b, G.TABLE_ID_XOR)
                for a in range(w)
                for b in range(w)
            ]
        if self.range_bits:
            rows += [
                (v, 0, 0, G.TABLE_ID_RANGE)
                for v in range(1 << self.range_bits)
            ]
        rows += [(k, 0, 0, G.TABLE_ID_RUNTIME) for k in range(self.rt_size)]
        assert len(rows) <= self.n, (
            f"{len(rows)} table rows exceed domain {self.n}"
        )
        return rows + [(0, 0, 0, 0)] * (self.n - len(rows))

    def rt_rows(self) -> range:
        """Domain rows occupied by the runtime table."""
        start = (
            len(self.lookup_table)
            + ((1 << self.xor_bits) ** 2 if self.xor_bits else 0)
            + ((1 << self.range_bits) if self.range_bits else 0)
        )
        return range(start, start + self.rt_size)

    def table_column_evals(self) -> list[list[int]]:
        """JOINT_WIDTH col evals + ids + rt_sel (5 lists of length n)."""
        rows = self.table_rows()
        cols = [[r[k] for r in rows] for k in range(3)]
        ids = [r[3] for r in rows]
        rt_sel = [0] * self.n
        for i in self.rt_rows():
            rt_sel[i] = 1
        return cols + [ids, rt_sel]

    def q_lookup_evals(self) -> list[int]:
        q = list(self.q_lookup) or [0] * self.n
        return q + [0] * (self.n - len(q))

    def tensors(self, device) -> dict:
        """The fixed columns as REP tensors on `device` (cached): coeffs
        (COEFFS, n, 22), sel (gate name -> (n, 22)), q_lookup (n, 22),
        table (5, n, 22: col0..2, ids, rt_sel), sigma (PERMUTS, n, 22)."""
        cache = self.__dict__.setdefault("_tensors", {})
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = str(device)
        if key not in cache:
            fs = self.domain.field
            flat = [v for col in self.coeffs for v in col]
            cache[key] = {
                "coeffs": ffl.from_ints(fs, flat, device).reshape(COEFFS, self.n, ffl.REP_LIMBS),
                "sel": {g: ffl.from_ints(fs, self.sel[g], device) for g in G.GATE_ORDER},
                "q_lookup": ffl.from_ints(fs, self.q_lookup_evals(), device),
                "table": ffl.from_ints(fs, [v for col in self.table_column_evals() for v in col], device).reshape(
                    5, self.n, ffl.REP_LIMBS
                ),
                "sigma": self.sigma_evals_t(device),
            }
        return cache[key]

    def check_witness(self, w: list[list[int]], pub: list[int], w_t: torch.Tensor | None = None, device=None) -> None:
        """Assert every gate, copy and lookup constraint holds, on `device`
        (the card unless "cpu"). w_t, the witness already as (COLUMNS, n,
        22) REP on a device, saves its conversion and picks the device."""
        from .. import device as _device
        from .prover_vec import vec_ops

        fs = self.domain.field
        p = fs.p
        n = self.n
        if w_t is None:
            flat = [v for col in w for v in col]
            w_t = ffl.from_ints(fs, flat, _device(device)).reshape(COLUMNS, n, ffl.REP_LIMBS)
        dev = w_t.device
        cols = self.tensors(dev)
        ops = vec_ops(p)
        ctx = gate_ctx(fs)
        pub_t = ffl.from_ints(fs, [pub[i] if i < len(pub) else 0 for i in range(n)], dev)
        for r0 in range(0, n, ROW_BLOCK):
            r1 = min(n, r0 + ROW_BLOCK)
            nxt = torch.arange(r0 + 1, r1 + 1, device=dev) % n
            row = G.RowView(
                w=list(w_t[:, r0:r1]), w_next=list(w_t[:, nxt]), c=list(cols["coeffs"][:, r0:r1])
            )
            per_gate = G.gate_constraints(ops, row, ctx, pub_t[r0:r1])
            for name in G.GATE_ORDER:
                on = torch.as_tensor(self.sel[name][r0:r1], device=dev) != 0
                for j, e in enumerate(per_gate[name]):
                    bad = on & ~ffl.is_zero(fs, e) if torch.is_tensor(e) else on & bool(e % p)
                    if bool(bad.any()):
                        i = r0 + int(bad.nonzero()[0, 0])
                        raise AssertionError(f"{name} constraint {j} failed at row {i}")
        if self.wiring:
            src = np.array([c * n + r for (c, r) in self.wiring], np.int64)
            dst = np.array([c * n + r for (c, r) in self.wiring.values()], np.int64)
            canon = ffl.canon(fs, w_t[:PERMUTS].reshape(PERMUTS * n, ffl.REP_LIMBS))
            diff = (canon[torch.as_tensor(src, device=dev)] != canon[torch.as_tensor(dst, device=dev)]).any(-1)
            if bool(diff.any()):
                k = int(diff.nonzero()[0, 0])
                raise AssertionError(f"copy constraint failed {(int(src[k]) // n, int(src[k]) % n)}")
        table = set(self.lookup_table)
        for i, q in enumerate(self.q_lookup_evals()):
            if q:
                assert w[0][i] in table, f"lookup failed at row {i}"
        xw = 1 << self.xor_bits
        for i in range(n):
            if self.sel[G.GATE_XOR][i]:
                for q in range(G.LOOKUPS_PER_ROW):
                    a, b, c = w[3 + q][i], w[7 + q][i], w[11 + q][i]
                    assert a < xw and b < xw and (a ^ b) == c, f"xor lookup failed at row {i} slot {q}"
            if self.sel[G.GATE_RANGECHECK][i]:
                for q in range(G.LOOKUPS_PER_ROW):
                    assert w[1 + q][i] < (1 << self.range_bits), f"range lookup failed at row {i} slot {q}"
            if self.sel[G.GATE_LOOKUP_RT][i]:
                for q in range(3):
                    assert w[1 + 2 * q][i] < self.rt_size, f"runtime lookup index out of range at row {i}"


class CircuitBuilder:
    """Builder: generic helper gates + poseidon/EC gadgets.

    `rows` entries are either a 5-tuple (generic row: ql qr qo qm qc) or
    a pair (gate_name, coeffs15) for custom gates.
    """

    def __init__(self, field: FieldSpec, log_size: int):
        self.domain = Domain(field, log_size)
        self.rows: list = []
        self.cycles: list[list[tuple[int, int]]] = []
        self.npub = 0
        self.lookup_table: list[int] = [0]
        self.lookup_rows: list[int] = []
        self.xor_bits = 0
        self.range_bits = 0
        self.rt_size = 0

    def set_lookup_table(self, table: list[int]) -> None:
        assert 0 in table, "table entry 0 is the non-lookup dummy"
        self.lookup_table = sorted(set(table))

    def enable_xor(self, bits: int) -> None:
        """Add the (2^bits)^2-row XOR table (id 1)."""
        self.xor_bits = bits

    def enable_range(self, bits: int) -> None:
        """Add the 2^bits-row range table (id 2)."""
        self.range_bits = bits

    def set_runtime_table(self, size: int) -> None:
        """Reserve a `size`-row runtime table (id 3); values are supplied
        per proof via prove(..., runtime_table=[...])."""
        self.rt_size = size

    def xor_gate(self) -> dict:
        """One xor row: in1 ^ in2 = out over 4*xor_bits bits.
        Witness: fill the nibble cells little-endian."""
        assert self.xor_bits
        row = len(self.rows)
        coeffs = [0] * COEFFS
        coeffs[0] = 1 << self.xor_bits
        self.rows.append((G.GATE_XOR, coeffs))
        return {
            "row": row,
            "in1": (0, row),
            "in2": (1, row),
            "out": (2, row),
            "nibs1": [(3 + q, row) for q in range(G.LOOKUPS_PER_ROW)],
            "nibs2": [(7 + q, row) for q in range(G.LOOKUPS_PER_ROW)],
            "nibs_out": [(11 + q, row) for q in range(G.LOOKUPS_PER_ROW)],
        }

    def range_gate(self) -> dict:
        """One rangecheck row: w0 < 2^(4*range_bits)."""
        assert self.range_bits
        row = len(self.rows)
        coeffs = [0] * COEFFS
        coeffs[0] = 1 << self.range_bits
        self.rows.append((G.GATE_RANGECHECK, coeffs))
        return {
            "row": row,
            "value": (0, row),
            "limbs": [(1 + q, row) for q in range(G.LOOKUPS_PER_ROW)],
        }

    def lookup_rt_gate(self) -> dict:
        """One runtime-lookup row: 3 (index, value) queries into the
        runtime table. ALL three pairs must hold valid queries (the
        always-on shape) — repeat a pair to look up fewer."""
        assert self.rt_size
        row = len(self.rows)
        self.rows.append((G.GATE_LOOKUP_RT, None))
        return {
            "row": row,
            "pairs": [((1 + 2 * q, row), (2 + 2 * q, row)) for q in range(3)],
        }

    def lookup_row(self) -> tuple[int, int]:
        """A constraint-free row whose w0 must be in the lookup table."""
        row = len(self.rows)
        self.rows.append((0, 0, 0, 0, 0))
        self.lookup_rows.append(row)
        return (0, row)

    # --- generic helpers (compatible with the round-1 API) ---
    def public_input(self) -> tuple[int, int]:
        assert not self.rows or self.npub == len(self.rows), "publics first"
        row = len(self.rows)
        p = self.domain.field.p
        self.rows.append((p - 1, 0, 0, 0, 0))  # -w0 + pub = 0
        self.npub += 1
        return (0, row)

    def mul_gate(self) -> tuple:
        row = len(self.rows)
        p = self.domain.field.p
        self.rows.append((0, 0, p - 1, 1, 0))
        return ((0, row), (1, row), (2, row))

    def add_gate(self) -> tuple:
        row = len(self.rows)
        p = self.domain.field.p
        self.rows.append((1, 1, p - 1, 0, 0))
        return ((0, row), (1, row), (2, row))

    def zero_row(self) -> int:
        """A constraint-free row (pass-through cells)."""
        row = len(self.rows)
        self.rows.append((0, 0, 0, 0, 0))
        return row

    # --- kimchi gadgets ---
    def poseidon_permutation(self, nrows: int | None = None):
        """Add an nrows-row poseidon span + 1 output row (default: the
        full 11-row / 55-round kimchi permutation).

        Returns (input_cells, output_cells, rows): input cells are
        (col 0..2, first row); outputs are (col 0..2, output row).
        """
        ps = poseidon_spec(self.domain.field.name)
        if nrows is None:
            nrows = len(ps.round_constants) // G.ROUNDS_PER_ROW  # 11
        assert nrows <= len(ps.round_constants) // G.ROUNDS_PER_ROW
        first = len(self.rows)
        for r in range(nrows):
            coeffs = [0] * COEFFS
            for i in range(G.ROUNDS_PER_ROW):
                for j in range(WIDTH):
                    coeffs[3 * i + j] = ps.round_constants[
                        G.ROUNDS_PER_ROW * r + i
                    ][j]
            self.rows.append((G.GATE_POSEIDON, coeffs))
        out_row = self.zero_row()
        ins = [(j, first) for j in range(WIDTH)]
        outs = [(j, out_row) for j in range(WIDTH)]
        return ins, outs, list(range(first, out_row + 1))

    def complete_add(self) -> dict:
        """Add one complete_add row; returns the register cell map."""
        row = len(self.rows)
        self.rows.append((G.GATE_COMPLETE_ADD, None))
        names = "x1 y1 x2 y2 x3 y3 inf same_x s inf_z x21_inv".split()
        return {name: (i, row) for i, name in enumerate(names)} | {"row": row}

    def varbasemul_chunk(self) -> dict:
        """One varbasemul 2-row chunk (5 scalar bits). Returns the cell
        map; consecutive chunks chain via connect(acc_out, acc_in) and
        connect(n_out, n_in)."""
        row = len(self.rows)
        self.rows.append((G.GATE_VARBASEMUL, None))
        aux = self.zero_row()
        return {
            "row": row,
            "T": ((0, row), (1, row)),
            "acc_in": ((2, row), (3, row)),
            "n_in": (4, row),
            "n_out": (5, row),
            "acc_out": ((0, aux), (1, aux)),
            "bits": [(2 + i, aux) for i in range(G.VBMUL_BITS_PER_CHUNK)],
        }

    def endomul_row(self) -> dict:
        """One endomul row (4 scalar bits). Consecutive endomul rows
        chain automatically (output in the next row's xP/yP/n slots);
        after the LAST one call endomul_terminal()."""
        row = len(self.rows)
        self.rows.append((G.GATE_ENDOMUL, None))
        return {
            "row": row,
            "T": ((0, row), (1, row)),
            "acc_in": ((4, row), (5, row)),
            "n_in": (6, row),
            "bits": [(11 + i, row) for i in range(4)],
        }

    def endomul_terminal(self) -> dict:
        """Constraint-free row catching the last endomul row's output."""
        row = self.zero_row()
        return {"row": row, "acc_out": ((4, row), (5, row)), "n_out": (6, row)}

    def endomulscalar_row(self) -> dict:
        """One endomulscalar row (8 crumbs = 16 challenge bits).
        Chain via connect(n8/a8/b8 -> next row's n0/a0/b0)."""
        row = len(self.rows)
        self.rows.append((G.GATE_ENDOMULSCALAR, None))
        names = "n0 n8 a0 b0 a8 b8".split()
        cells = {name: (i, row) for i, name in enumerate(names)}
        cells["crumbs"] = [
            (6 + i, row) for i in range(G.EMSCALAR_CRUMBS_PER_ROW)
        ]
        cells["row"] = row
        return cells

    def connect(self, cells: list[tuple[int, int]]) -> None:
        self.cycles.append(list(cells))

    def build(self) -> Circuit:
        n = self.domain.n
        # the last ZK_ROWS rows carry random values, and the row before
        # them may be read as w_next by the last gate row: keep them free
        assert len(self.rows) + 1 <= n - ZK_ROWS, (
            f"{len(self.rows)} rows do not fit domain {n} with "
            f"{ZK_ROWS} zk rows"
        )
        coeffs = [[0] * n for _ in range(COEFFS)]
        sel = {g: [0] * n for g in G.GATE_ORDER}
        for i, spec in enumerate(self.rows):
            if isinstance(spec, tuple) and len(spec) == 5 and not isinstance(
                spec[0], str
            ):
                sel[G.GATE_GENERIC][i] = 1
                for j in range(5):
                    coeffs[j][i] = spec[j]
            else:
                kind, cf = spec
                sel[kind][i] = 1
                if cf:
                    for j in range(COEFFS):
                        coeffs[j][i] = cf[j]
        # zero rows: leave all selectors off
        for i, spec in enumerate(self.rows):
            if (
                isinstance(spec, tuple)
                and len(spec) == 5
                and not isinstance(spec[0], str)
                and all(v == 0 for v in spec)
            ):
                sel[G.GATE_GENERIC][i] = 0
        # merge copy constraints with union-find: a cell may appear in many
        # connect() calls; sigma must be one rotation per equivalence class
        parent: dict = {}

        def find(x):
            while parent.get(x, x) != x:
                parent[x] = parent.get(parent[x], parent[x])
                x = parent[x]
            return x

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        for cyc in self.cycles:
            for cell in cyc[1:]:
                union(cyc[0], cell)
        classes: dict = {}
        seen = set()
        for cyc in self.cycles:
            for cell in cyc:
                if cell not in seen:
                    seen.add(cell)
                    classes.setdefault(find(cell), []).append(cell)
        wiring = {}
        for members in classes.values():
            members = sorted(members)
            for i, cell in enumerate(members):
                wiring[cell] = members[(i + 1) % len(members)]
        q_lookup = [0] * n
        for r in self.lookup_rows:
            assert r < n - 1, "last row is excluded from lookups"
            q_lookup[r] = 1
        return Circuit(
            domain=self.domain,
            npub=self.npub,
            coeffs=coeffs,
            sel=sel,
            wiring=wiring,
            lookup_table=self.lookup_table,
            q_lookup=q_lookup,
            xor_bits=self.xor_bits,
            range_bits=self.range_bits,
            rt_size=self.rt_size,
        )
