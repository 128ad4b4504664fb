"""Sudoku generation/solving (parity with the reference's
example/mina_zkapp/src/sudoku-lib.js:1-199).

The port's own copy of example/sudoku_lib.py: the same seeded rng calls
give the same puzzles."""

from __future__ import annotations

import random


def solve(grid: list[list[int]]) -> list[list[int]] | None:
    g = [row[:] for row in grid]

    def ok(r, c, v):
        if any(g[r][j] == v for j in range(9)):
            return False
        if any(g[i][c] == v for i in range(9)):
            return False
        br, bc = 3 * (r // 3), 3 * (c // 3)
        return all(
            g[br + i][bc + j] != v for i in range(3) for j in range(3)
        )

    def backtrack():
        for r in range(9):
            for c in range(9):
                if g[r][c] == 0:
                    for v in range(1, 10):
                        if ok(r, c, v):
                            g[r][c] = v
                            if backtrack():
                                return True
                            g[r][c] = 0
                    return False
        return True

    return g if backtrack() else None


def generate(rng: random.Random, holes: int = 40):
    """-> (puzzle with 0 holes, solution)."""
    base = [[0] * 9 for _ in range(9)]
    # seed a random complete grid via randomized solve
    order = list(range(1, 10))
    rng.shuffle(order)
    for i in range(9):
        base[0][i] = order[i]
    solution = solve(base)
    assert solution is not None
    puzzle = [row[:] for row in solution]
    cells = [(r, c) for r in range(9) for c in range(9)]
    rng.shuffle(cells)
    for r, c in cells[:holes]:
        puzzle[r][c] = 0
    return puzzle, solution


def is_valid_solution(puzzle, solution) -> bool:
    for r in range(9):
        for c in range(9):
            if puzzle[r][c] and puzzle[r][c] != solution[r][c]:
                return False
            if not 1 <= solution[r][c] <= 9:
                return False
    groups = []
    groups += [[(r, c) for c in range(9)] for r in range(9)]
    groups += [[(r, c) for r in range(9)] for c in range(9)]
    groups += [
        [(3 * br + i, 3 * bc + j) for i in range(3) for j in range(3)]
        for br in range(3)
        for bc in range(3)
    ]
    return all(
        sorted(solution[r][c] for r, c in grp) == list(range(1, 10))
        for grp in groups
    )
