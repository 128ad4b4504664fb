"""Sudoku zkApp: the Mina-side circuit + account-state model.

Parity with the reference's o1js zkApp (example/mina_zkapp/src/
sudoku.ts:27-109: on-chain state `sudokuHash`, `isSolved`;
`submitSolution` proves a valid solution of the committed puzzle). The
circuit is built in the port's proof system (kimchi/circuit.py) as a real
constraint system over the 81 cells:

* givens: solution cell == puzzle cell wherever the puzzle is filled;
* each of the 27 groups (rows/columns/boxes) satisfies sum == 45 and
  sum of squares == 285;
* per-cell range: prod_{v=1..9} (cell - v) == 0, packed two factors per
  generic row via the qm quadratic term.

Public inputs: the Poseidon hash of the puzzle (sudokuHash) and the
solved flag. ~1200 rows -> 2^11 domain.

Rows and their witness fillers are built together (a "plan"), so the
witness layout can never drift from the constraint layout.

The port's counterpart of example/sudoku_zkapp.py: the same rows,
wiring, witness and public inputs; `SudokuCircuit.prove` runs the port's
setup and prove on `device` (the card unless "cpu").
"""

from __future__ import annotations

import random

from ..curves.host import PALLAS
from ..hash import poseidon
from ..hash.poseidon_params import poseidon_spec
from ..kimchi.circuit import COLUMNS, CircuitBuilder
from . import sudoku_lib

FS = PALLAS.scalar
LOG_N = 11  # 2048 rows


def puzzle_hash(puzzle: list[list[int]]) -> int:
    """Poseidon commitment of the 81 puzzle cells (0 = hole)."""
    ps = poseidon_spec("fq")
    flat = [puzzle[r][c] for r in range(9) for c in range(9)]
    return poseidon.host_hash(ps, flat)


def _groups():
    g = [[(r, c) for c in range(9)] for r in range(9)]
    g += [[(r, c) for r in range(9)] for c in range(9)]
    g += [
        [(3 * br + i, 3 * bc + j) for i in range(3) for j in range(3)]
        for br in range(3)
        for bc in range(3)
    ]
    return g


class SudokuCircuit:
    def __init__(self, puzzle: list[list[int]]):
        self.puzzle = puzzle
        p = FS.p
        b = CircuitBuilder(FS, LOG_N)
        plan = []  # fill steps: (row, fn(sol_values) -> (w0, w1, w2))

        pub_hash = b.public_input()
        pub_solved = b.public_input()

        def add_row(sel, fill, wires=()):
            row = len(b.rows)
            b.rows.append(sel)
            plan.append((row, fill))
            for col, cell in wires:
                b.connect([cell, (col, row)])
            return row

        # cell rows: w0*w1 = w2 with w0 == w1 == cell (cell^2 in w2)
        cell_cells = {}
        sq_cells = {}
        for r in range(9):
            for c in range(9):
                row = add_row(
                    (0, 0, p - 1, 1, 0),
                    lambda s, rc=(r, c): (s[rc], s[rc], s[rc] * s[rc] % p),
                )
                b.connect([(0, row), (1, row)])
                cell_cells[(r, c)] = (0, row)
                sq_cells[(r, c)] = (2, row)

        # givens: cell - g == 0
        for r in range(9):
            for c in range(9):
                if puzzle[r][c]:
                    g = puzzle[r][c]
                    add_row(
                        (1, 0, 0, 0, (-g) % p),
                        lambda s, rc=(r, c): (s[rc], 0, 0),
                        wires=[(0, cell_cells[(r, c)])],
                    )

        # group sums: 7 chained adds + final (acc + last - total == 0)
        def sum_chain(cells_xy, value_of, total):
            acc_cell = cells_xy[0]
            acc_val = lambda s, cc=cells_xy[0]: value_of(s, cc)
            for nxt in cells_xy[1:-1]:
                prev_val = acc_val
                row = add_row(
                    (1, 1, p - 1, 0, 0),
                    lambda s, pv=prev_val, nn=nxt: (
                        pv(s),
                        value_of(s, nn),
                        (pv(s) + value_of(s, nn)) % p,
                    ),
                    wires=[(0, acc_cell), (1, nxt)],
                )
                acc_cell = (2, row)
                acc_val = lambda s, pv=prev_val, nn=nxt: (
                    pv(s) + value_of(s, nn)
                ) % p
            prev_val = acc_val
            add_row(
                (1, 1, 0, 0, (-total) % p),
                lambda s, pv=prev_val, nn=cells_xy[-1]: (
                    pv(s),
                    value_of(s, nn),
                    0,
                ),
                wires=[(0, acc_cell), (1, cells_xy[-1])],
            )

        cellv = lambda s, rc: s[rc]
        sqv = lambda s, rc: s[rc] * s[rc] % p
        for grp in _groups():
            sum_chain([cell_cells[x] for x in grp], lambda s, cc: s[_cell_of(cell_cells, cc)], 45)
            sum_chain([sq_cells[x] for x in grp], lambda s, cc: _sq_of(sq_cells, cc, s), 285)

        # range: prod_{v=1..9}(cell - v) == 0
        for r in range(9):
            for c in range(9):
                cell = cell_cells[(r, c)]
                val = lambda s, rc=(r, c): s[rc]
                # f_i = (cell - a)(cell - b): qm=1 ql=-(a+b) qo=-1 qc=ab
                fcells = []
                fvals = []
                for a, bb in ((1, 2), (3, 4), (5, 6), (7, 8)):
                    row = add_row(
                        (
                            (-(a + bb)) % p,
                            0,
                            p - 1,
                            1,
                            (a * bb) % p,
                        ),
                        lambda s, v=val, aa=a, bbb=bb: (
                            v(s),
                            v(s),
                            (v(s) - aa) * (v(s) - bbb) % p,
                        ),
                        wires=[(0, cell), (1, cell)],
                    )
                    fcells.append((2, row))
                    fvals.append(
                        lambda s, v=val, aa=a, bbb=bb: (v(s) - aa)
                        * (v(s) - bbb)
                        % p
                    )
                # g1 = f1*f2, g2 = f3*f4, g3 = g1*g2
                def mulrow(c1, v1, c2, v2):
                    row = add_row(
                        (0, 0, p - 1, 1, 0),
                        lambda s, a=v1, bb=v2: (a(s), bb(s), a(s) * bb(s) % p),
                        wires=[(0, c1), (1, c2)],
                    )
                    return (2, row), lambda s, a=v1, bb=v2: a(s) * bb(s) % p

                g1c, g1v = mulrow(fcells[0], fvals[0], fcells[1], fvals[1])
                g2c, g2v = mulrow(fcells[2], fvals[2], fcells[3], fvals[3])
                g3c, g3v = mulrow(g1c, g1v, g2c, g2v)
                # final: (cell - 9) * g3 == 0: qm w0 w1 - 9 w1 = 0
                add_row(
                    (0, (-9) % p, 0, 1, 0),
                    lambda s, v=val, gv=g3v: (v(s), gv(s), 0),
                    wires=[(0, cell), (1, g3c)],
                )

        self.pub_cells = (pub_hash, pub_solved)
        self.plan = plan
        self.builder = b
        self.circuit = b.build()
        assert len(b.rows) <= self.circuit.n

    def witness(self, solution: list[list[int]]):
        p = FS.p
        n = self.circuit.n
        w = [[0] * n for _ in range(COLUMNS)]
        s = {(r, c): solution[r][c] for r in range(9) for c in range(9)}
        pub = [puzzle_hash(self.puzzle) % p, 1]
        w[0][self.pub_cells[0][1]] = pub[0]
        w[0][self.pub_cells[1][1]] = pub[1]
        for row, fill in self.plan:
            w0, w1, w2 = fill(s)
            w[0][row], w[1][row], w[2][row] = w0 % p, w1 % p, w2 % p
        return w, pub

    def prove(self, solution, g, h, rng=None, device=None):
        """(index, proof) of `solution` over the SRS prefix g (a (N, 2, 20)
        array) and h, set up and proven on `device` (the card unless
        "cpu")."""
        from ..kimchi import prover_host

        rng = rng or random.Random(0x5D0)
        index = prover_host.setup(self.circuit, PALLAS, g, h, device=device)
        w, pub = self.witness(solution)
        proof = prover_host.prove(index, self.circuit, w, pub, g, h, rng, device=device)
        return index, proof


def _cell_of(cell_cells, cc):
    for rc, c in cell_cells.items():
        if c == cc:
            return rc
    raise KeyError(cc)


def _sq_of(sq_cells, cc, s):
    for rc, c in sq_cells.items():
        if c == cc:
            return s[rc] * s[rc] % FS.p
    raise KeyError(cc)


class SudokuZkApp:
    """Account-state model (sudokuHash, isSolved) like sudoku.ts:27-109."""

    def __init__(self, puzzle):
        self.sudoku_hash = puzzle_hash(puzzle)
        self.is_solved = 0
        self.puzzle = puzzle

    def update(self, new_puzzle):
        self.puzzle = new_puzzle
        self.sudoku_hash = puzzle_hash(new_puzzle)
        self.is_solved = 0

    def submit_solution(self, solution) -> None:
        if not sudoku_lib.is_valid_solution(self.puzzle, solution):
            raise ValueError("sudoku solution is invalid")
        self.is_solved = 1

    def app_state(self) -> list[int]:
        return [self.sudoku_hash, self.is_solved] + [0] * 6
