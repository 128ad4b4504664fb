"""The port's Sudoku consumer (mina_bridge_tpu_torch/example) on the CPU
against the JAX package's example/ (sudoku_lib.py, sudoku_zkapp.py,
app.py): the puzzle, the circuit's rows, wiring and lookup columns, the
witness and public inputs, the witness check, the puzzle hash and the
port's `hash/poseidon.py::host_hash`, the zkApp's state transitions, the
zkApp account through the port's Proof-of-Account verify, and the app's
command line. Tolerance zero: equal ints, rows, verdicts and reasons.

Nothing is proven here: the port's Sudoku proof at 2^11 runs on the card
(chip_smoke.py, against fixtures/sudoku_2e11.json.gz, which the JAX
package's host prover wrote). The account's expected verdicts are the JAX
package's host oracles' (tests/test_torch_bridge.py::_account_reason).
"""

import dataclasses
import importlib.util
import pathlib
import random
import sys

import pytest
import torch

from mina_bridge_tpu.bridge import fixtures as jfx
from mina_bridge_tpu.bridge import mina_types as jmt
from mina_bridge_tpu.bridge import proof_model as jpm
from mina_bridge_tpu.bridge import sol_codec as jsol
from mina_bridge_tpu.fields.params import FP
from mina_bridge_tpu.hash import poseidon as jposeidon
from mina_bridge_tpu.hash.poseidon_params import poseidon_spec as jspec
from mina_bridge_tpu_torch.bridge import proof_model as tpm
from mina_bridge_tpu_torch.bridge import verifier_service as tvs
from mina_bridge_tpu_torch.example import app as tapp
from mina_bridge_tpu_torch.example import sudoku_lib as tlib
from mina_bridge_tpu_torch.example import sudoku_zkapp as tz
from mina_bridge_tpu_torch.hash import poseidon as tposeidon
from mina_bridge_tpu_torch.hash.poseidon_params import poseidon_spec as tspec
from tests.test_torch_bridge import _account_reason
from tests.test_torch_prover import _circuit_fields

torch.set_num_threads(1)

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "example"
sys.path.insert(0, str(EXAMPLE))  # as tests/test_example_sudoku.py imports them

import sudoku_lib as jlib  # noqa: E402
import sudoku_zkapp as jz  # noqa: E402


def _jax_app():
    """example/app.py under a name of its own (its module name is "app")."""
    spec = importlib.util.spec_from_file_location("jax_example_app", EXAMPLE / "app.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sudoku():
    """tests/test_example_sudoku.py's puzzle (random.Random(0x5D0), 30
    holes) from both packages' generators, and both circuits over it."""
    jrng, trng = random.Random(0x5D0), random.Random(0x5D0)
    puzzle, solution = jlib.generate(jrng, holes=30)
    assert tlib.generate(trng, holes=30) == (puzzle, solution) and trng.getstate() == jrng.getstate()
    return puzzle, solution, jz.SudokuCircuit(puzzle), tz.SudokuCircuit(puzzle)


def test_sudoku_circuit_and_witness_match_jax(sudoku):
    """The port's SudokuCircuit at LOG_N = 11: the same circuit fields and
    public-input cells, the same witness and public inputs; the port's
    witness check (every gate over all rows on tensors) passes on the
    solution and raises on a solution with bad[3][3] = bad[3][4]."""
    puzzle, solution, jc, tc = sudoku
    assert tz.LOG_N == jz.LOG_N == 11 and len(tc.builder.rows) == len(jc.builder.rows) <= tc.circuit.n
    assert _circuit_fields(tc.circuit) == _circuit_fields(jc.circuit) and tc.pub_cells == jc.pub_cells
    bad = [row[:] for row in solution]
    bad[3][3] = bad[3][4]
    for sol, ok in ((solution, True), (bad, False)):
        (tw, tpub), (jw, jpub) = tc.witness(sol), jc.witness(sol)
        assert (tw, tpub) == (jw, jpub)
        if ok:
            tc.circuit.check_witness(tw, tpub, device="cpu")
        else:
            with pytest.raises(AssertionError):
                tc.circuit.check_witness(tw, tpub, device="cpu")


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_puzzle_hash_and_host_hash_match_jax(sudoku, field):
    """puzzle_hash (over Fq) and host_hash on seeded inputs of 0-5 and 81
    elements: the JAX package's values."""
    puzzle = sudoku[0]
    assert tz.puzzle_hash(puzzle) == jz.puzzle_hash(puzzle)
    rng = random.Random(field)
    tps, jps = tspec(field), jspec(field)
    for n in (0, 1, 2, 3, 5, 81):
        xs = [rng.randrange(tps.field.p) for _ in range(n)]
        assert tposeidon.host_hash(tps, xs) == jposeidon.host_hash(jps, xs)


def test_zkapp_state_transitions(sudoku):
    """SudokuZkApp: the state after a valid solution, a refused invalid one
    and a puzzle update, each equal to the JAX zkApp's."""
    puzzle, solution = sudoku[:2]
    apps = [tz.SudokuZkApp(puzzle), jz.SudokuZkApp(puzzle)]
    bad = [row[:] for row in solution]
    bad[3][3] = bad[3][4]
    for app in apps:
        with pytest.raises(ValueError):
            app.submit_solution(bad)
    assert apps[0].app_state() == apps[1].app_state() and apps[0].is_solved == 0
    for app in apps:
        app.submit_solution(solution)
    assert apps[0].app_state() == apps[1].app_state() and apps[0].app_state()[:2] == [tz.puzzle_hash(puzzle), 1]
    other = [row[::-1] for row in puzzle]
    for app in apps:
        app.update(other)
    assert apps[0].app_state() == apps[1].app_state() and apps[0].is_solved == 0


def test_zkapp_account_through_the_port_verify(sudoku):
    """The solved zkApp's account (its app state the zkApp's) as the only
    leaf of a depth-35 ledger: the port's Proof-of-Account verify on the
    CPU (one batch of the honest submission and one against the ledger
    hash ^ 1) accepts the first and rejects the second with the JAX
    package's reason."""
    puzzle, solution = sudoku[:2]
    app = tz.SudokuZkApp(puzzle)
    app.submit_solution(solution)
    account = jfx.make_account(random.Random(0x5D1), with_zkapp=True)
    account["zkapp"]["app_state"] = [x % FP.p for x in app.app_state()]
    ledger = jfx.SparseLedger()
    ledger.set_leaf(7, jpm.host_account_hash(account))
    pub = jpm.MinaAccountPubInputs(ledger_hash=ledger.root(), encoded_account=jsol.encode_account_sol(account))
    proof = jpm.MinaAccountProof(merkle_path=ledger.path(7), account=jmt.ACCOUNT.encode(account))
    pubs = [pub, dataclasses.replace(pub, ledger_hash=pub.ledger_hash ^ 1)]
    got = tvs.verify_accounts_batch([tpm.MinaAccountPubInputs.decode(p.encode()) for p in pubs],
                                    [tpm.MinaAccountProof.decode(proof.encode())] * 2, "cpu")
    want = [_account_reason(p, proof) for p in pubs]
    assert [(r.ok, r.reason) for r in got] == [(w == "", w) for w in want] == [(True, ""), (False, "merkle root != ledger hash")]
    assert account["zkapp"]["app_state"][1] == 1


@pytest.mark.parametrize("argv", [[], ["bogus"], ["validate-solution"], ["validate-solution", "B62qsudoku"]])
def test_app_main_exits_as_jax(argv):
    """app.main parses as the JAX app does: a usage error exits 2, and
    validate-solution from the command line exits with the message that
    it needs contracts configured in-process."""
    with pytest.raises(SystemExit) as t:
        tapp.main(argv)
    with pytest.raises(SystemExit) as j:
        _jax_app().main(argv)
    if isinstance(j.value.code, int):
        assert t.value.code == j.value.code == 2
    else:
        assert t.value.code.split(";")[0] == j.value.code.split(";")[0] == "validate-solution requires configured contracts"
