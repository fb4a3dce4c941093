"""TorchState and TorchOperator against TpuState and TpuOperator.

Every case of ``tests/test_tpu_state_op.py`` and
``tests/test_state_operator_abc.py`` (their serialization checks aside:
the JSON layer is not ported) runs through both packages on the same
inputs (:func:`torch_parity.assert_parity`): the same values within
1e-12 in complex128, the same seeded counts, the same errors. The
serialization dicts (``_to_abstract_repr``) are compared directly.

The port keeps an operator built from its representation as a term list
and applies it along the qudit axes; its ``expect`` and ``apply_to`` are
pinned against the dense ``to_qobj()`` product at n ≤ 6, for kets and
density matrices, to 1e-12.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from torch_parity import JAX, TORCH, assert_parity

from pulser_tpu_torch.backend.operator import Operator
from pulser_tpu_torch.backend.state import State
from pulser_tpu_torch.emulator import Qobj, TorchOperator, TorchState

torch.set_num_threads(1)

TOL = 1e-12


def ket_r(ns):
    return ns.State(ns.basis(2, 0), eigenstates=("r", "g"))


def dm_g(ns):
    return ns.State(ns.basis(2, 1).proj(), eigenstates=("r", "g"))


def ket_plus(ns):
    return ns.State.from_state_amplitudes(
        eigenstates=("r", "g"),
        amplitudes={"r": 1 / np.sqrt(2), "g": 1 / np.sqrt(2)},
    )


def sigma(ns, which):
    mats = {
        "i": np.eye(2),
        "x": np.array([[0, 1], [1, 0]]),
        "y": np.array([[0, -1j], [1j, 0]]),
        "z": np.array([[1, 0], [0, -1]]),
    }
    return ns.Operator(
        ns.Qobj(np.asarray(mats[which], dtype=complex)), eigenstates=("r", "g")
    )


def _amps_state(ns, amps, eig=("r", "g")):
    return ns.State.from_state_amplitudes(eigenstates=eig, amplitudes=amps)


def _probs(ns):
    amps = {"rr": np.sqrt(0.5), "gg": 1j * np.sqrt(0.5 - 1e-12), "gr": 1e-6}
    st = _amps_state(ns, amps)
    dm_plus = ns.State(
        ket_plus(ns).to_qobj().proj(), eigenstates=("r", "g")
    )
    return [
        st.probabilities(cutoff=9e-13),
        st.probabilities(),
        st.infer_one_state(),
        st.bitstring_probabilities(),
        st.bitstring_probabilities(one_state="g"),
        dm_plus.probabilities(),
        dm_plus.bitstring_probabilities(),
    ]


def _sample(ns):
    shots = 2000
    r, g = ket_r(ns), dm_g(ns)
    return [
        r.sample(num_shots=shots),
        r.sample(num_shots=shots, one_state="g"),
        r.sample(num_shots=shots, p_false_pos=0.1),
        r.sample(num_shots=shots, p_false_neg=0.1),
        g.sample(num_shots=shots),
        g.sample(num_shots=shots, one_state="g"),
        g.sample(num_shots=shots, p_false_neg=0.1),
        g.sample(num_shots=shots, p_false_pos=0.1),
        ket_plus(ns).sample(num_shots=shots, p_false_pos=0.2),
    ]


def _get_basis_state(ns):
    st = _amps_state(ns, {"ggg": 1.0}, ("r", "g", "h"))
    return [st.get_basis_state_from_index(i) for i in (0, 1, 2, 3, 4, 9, 26)]


def _overlaps(ns):
    r, g, p = ket_r(ns), dm_g(ns), ket_plus(ns)
    dm_plus = ns.State(p.to_qobj().proj(), eigenstates=p.eigenstates)
    return [
        r.overlap(r),
        g.overlap(r),
        r.overlap(g),
        p.overlap(r),
        r.overlap(p),
        g.overlap(p),
        p.overlap(g),
        g.overlap(dm_plus),
    ]


def _from_amplitudes(ns):
    return [
        _amps_state(ns, {"g": 1.0}),
        _amps_state(ns, {"g": 1.0}, ("g", "r")),
        _amps_state(ns, {"g": 1.0}, ("r", "g", "h")),
        _amps_state(ns, {"rr": -0.5j, "gr": 0.5, "rg": 0.5j, "gg": -0.5}),
    ]


def _repr_header(ns):
    return _repr_header_of(ket_r(ns))


def _repr_header_of(obj):
    lines = repr(obj).split("\n")
    return [lines[0], lines[1] == "-" * len(lines[0]), lines[2]]


def _eq(ns):
    r, g = ket_r(ns), dm_g(ns)
    return [
        r == _amps_state(ns, {"r": 1.0}),
        g != _amps_state(ns, {"g": 1.0}),
        g != ns.basis(2, 1).proj(),
    ]


def _state_serial(ns):
    st = _amps_state(ns, {"g": 1.0})
    return st._to_abstract_repr()


def _state_serial_not_from_amplitudes(ns):
    st = _amps_state(ns, {"g": 1.0})
    return ns.State(st.to_qobj(), eigenstates=st.eigenstates)._to_abstract_repr()


def _state_serial_mutated(ns):
    st = _amps_state(ns, {"g": 1.0})
    st._state = ket_r(ns)._state
    return st._to_abstract_repr()


STATE_CASES = {
    "init_validation-names": lambda ns: ns.State(
        ns.basis(2, 0), eigenstates=["ground", "rydberg"]
    ),
    "init_validation-repeated": lambda ns: ns.State(
        ns.basis(2, 0), eigenstates=["r", "g", "r"]
    ),
    "init_validation-set": lambda ns: ns.State(
        ns.basis(2, 0), eigenstates={"r", "g"}
    ),
    "init_validation-array": lambda ns: ns.State(
        np.arange(16), eigenstates=["r", "g"]
    ),
    "init_validation-qudit_dim": lambda ns: ns.State(
        ns.basis(2, 0), eigenstates=["r", "g", "h"]
    ),
    "init_bra_becomes_ket": lambda ns: (
        lambda st: [st.n_qudits, st.qudit_dim, st.eigenstates, st]
    )(ns.State(ns.basis(3, 0).dag(), eigenstates=["r", "g", "h"])),
    "init_bra_becomes_ket-one_state": lambda ns: ns.State(
        ns.basis(3, 0).dag(), eigenstates=["r", "g", "h"]
    ).infer_one_state(),
    "init_multi_qudit": lambda ns: [
        (lambda st: [st.n_qudits, st.qudit_dim, st, st.infer_one_state()])(
            ns.State(ns.tensor([ns.basis(2, 1)] * 3), eigenstates=("r", "g"))
        ),
        (lambda st: [st.n_qudits, st.qudit_dim, st])(
            ns.State(
                ns.tensor([ns.basis(3, 0)] * 2).proj(),
                eigenstates=["r", "g", "h"],
            )
        ),
    ],
    **{
        f"infer_one_state-{''.join(e)}": (
            lambda ns, e=e: ns.State(
                ns.basis(len(e), 0), eigenstates=e
            ).infer_one_state()
        )
        for e in [("g", "r"), ("g", "r", "x"), ("g", "h"), ("u", "d"), ("0", "1")]
    },
    "get_basis_state": _get_basis_state,
    "get_basis_state-negative": lambda ns: _amps_state(
        ns, {"g": 1.0}
    ).get_basis_state_from_index(-1),
    "overlap": _overlaps,
    "overlap_errors-type": lambda ns: dm_g(ns).overlap(ket_r(ns).to_qobj()),
    "overlap_errors-qudits": lambda ns: ket_r(ns).overlap(
        _amps_state(ns, {"rr": 1.0}, ("r", "g", "h"))
    ),
    "overlap_errors-eigenstates": lambda ns: ket_r(ns).overlap(
        ns.State(ns.basis(2, 0), eigenstates=("u", "d"))
    ),
    "overlap_errors-order": lambda ns: ket_r(ns).overlap(
        ns.State(ns.basis(2, 0), eigenstates=("g", "r"))
    ),
    "probabilities": _probs,
    "sample": _sample,
    "from_state_amplitudes_error-length": lambda ns: _amps_state(
        ns, {"rrh": 1.0}
    ),
    "from_state_amplitudes_error-mixed": lambda ns: _amps_state(
        ns, {"rr": 0.5, "rgg": np.sqrt(0.75)}
    ),
    "from_state_amplitudes": _from_amplitudes,
    "repr": _repr_header,
    "eq": _eq,
    "abstract_repr": _state_serial,
    "abstract_repr-not_from_amplitudes": _state_serial_not_from_amplitudes,
    "abstract_repr-mutated": _state_serial_mutated,
}


#: Errors the port words differently: it also takes torch tensors.
MESSAGES = {
    "init_validation-array": "must be a Qobj",
    "init-array": "must be a Qobj with type 'oper'",
    "init-ket": "must be a Qobj with type 'oper'",
}


@pytest.mark.parametrize("name", list(STATE_CASES))
def test_state_parity(name):
    """TestTpuState, case by case."""
    assert_parity(STATE_CASES[name], tol=TOL, message=MESSAGES.get(name))


def _op_errors_on_state(op_name, which):
    def case(ns):
        op = getattr(sigma(ns, "x"), op_name)
        arg = {
            "qobj": lambda: ns.basis(2, 0),
            "gh": lambda: ns.State(ns.basis(2, 0), eigenstates=("g", "h")),
            "gr": lambda: ns.State(ns.basis(2, 0), eigenstates=("g", "r")),
        }[which]()
        return op(arg)

    return case


def _op_errors_on_operator(op_name, which):
    def case(ns):
        op = getattr(sigma(ns, "x"), op_name)
        arg = {
            "state": lambda: ket_r(ns),
            "gh": lambda: ns.Operator(
                ns.basis(2, 0).proj(), eigenstates=("g", "h")
            ),
            "gr": lambda: ns.Operator(
                ns.basis(2, 0).proj(), eigenstates=("g", "r")
            ),
        }[which]()
        return op(arg)

    return case


def _expect(ns):
    x, y, z = (sigma(ns, w) for w in "xyz")
    r, g, p = ket_r(ns), dm_g(ns), ket_plus(ns)
    return [
        x.expect(r),
        x.expect(g),
        x.expect(p),
        x.expect(y.apply_to(p)),
        z.expect(r),
        z.expect(g),
        z.expect(p),
        y.expect(p),
    ]


def _algebra(ns):
    i, x, y, z = (sigma(ns, w) for w in "ixyz")
    r, g = ns.basis(2, 0), ns.basis(2, 1)
    eig = ("r", "g")
    return [
        x + y,
        x + y == ns.Operator(
            (1 - 1j) * (r @ g.dag()) + (1 + 1j) * (g @ r.dag()),
            eigenstates=eig,
        ),
        ns.Operator(ns.qeye(2), eigenstates=eig) + z,
        (1 - 2j) * i,
        0.5 * (i + z),
        x @ x == y @ y == z @ z == i,
        x @ z == -1j * y,
        z @ x == 1j * y,
        0.5 * (i + (-1) * z) == ns.Operator(
            ns.basis(2, 1).proj(), eigenstates=eig
        ),
        0.5 * (i + (-1) * z) != dm_g(ns),
    ]


def _repr_op(ns, ops, n=2, eig=("r", "g")):
    return ns.Operator.from_operator_repr(
        eigenstates=eig, n_qudits=n, operations=ops
    )


def _from_operator_repr(ns):
    return [
        _repr_op(
            ns,
            [(1.0, [({"rr": 1.0, "hh": -1.0}, {0}), ({"gr": -1j}, {2})])],
            n=3,
            eig=("r", "g", "h"),
        ),
        _repr_op(ns, [(1, [])], n=1),
        _repr_op(ns, [(0.5, [({"rr": 1.0, "gg": -1.0}, {0})]), (0.5, [])]),
    ]


def _op_serial(ns):
    return _repr_op(
        ns,
        [(0.5, [({"rr": 1.0, "gg": 1.0j}, {0})]), (0.5, [])],
        n=3,
    )._to_abstract_repr()


OPERATOR_CASES = {
    "init-names": lambda ns: ns.Operator(
        ns.Qobj(np.diag([1.0, -1.0])), eigenstates=["ground", "rydberg"]
    ),
    "init-repeated": lambda ns: ns.Operator(
        ns.Qobj(np.diag([1.0, -1.0])), eigenstates=["r", "g", "r"]
    ),
    "init-array": lambda ns: ns.Operator(
        np.diag([1.0, -1.0]), eigenstates=["r", "g"]
    ),
    "init-ket": lambda ns: ns.Operator(ns.basis(2, 0), eigenstates=["r", "g"]),
    "init-qudit_dim": lambda ns: ns.Operator(
        ns.Qobj(np.diag([1.0, -1.0])), eigenstates=["r", "g", "h"]
    ),
    "init": lambda ns: [sigma(ns, "z").eigenstates, sigma(ns, "z")],
    **{
        f"errors_on_state-{op}-{which}": _op_errors_on_state(op, which)
        for op in ("apply_to", "expect")
        for which in ("qobj", "gh", "gr")
    },
    **{
        f"errors_on_operator-{op}-{which}": _op_errors_on_operator(op, which)
        for op in ("__add__", "__matmul__")
        for which in ("state", "gh", "gr")
    },
    "apply_to": lambda ns: [
        sigma(ns, "x").apply_to(ket_r(ns)),
        sigma(ns, "x").apply_to(dm_g(ns)),
    ],
    "expect": _expect,
    "add_rmul_matmul_eq": _algebra,
    "from_operator_repr_key_errors-gggg": lambda ns: _repr_op(
        ns, [(1.0, [({"gggg": 1.0, "rr": -1.0}, {0})])]
    ),
    "from_operator_repr_key_errors-hh": lambda ns: _repr_op(
        ns, [(1.0, [({"hh": 1.0, "rr": -1.0}, {0})])]
    ),
    "from_operator_repr_index_errors-range": lambda ns: _repr_op(
        ns, [(1.0, [({"gg": 1.0, "rr": -1.0}, {3, 5, 9})])]
    ),
    "from_operator_repr_index_errors-twice": lambda ns: _repr_op(
        ns, [(1.0, [({"gg": 1.0, "rr": -1.0}, {0}), ({"rg": 1.0}, {0})])]
    ),
    "from_operator_repr": _from_operator_repr,
    "repr": lambda ns: _repr_header_of(sigma(ns, "z")),
    "abstract_repr": _op_serial,
    "abstract_repr-not_from_repr": lambda ns: ns.Operator(
        sigma(ns, "z").to_qobj(), eigenstates=("r", "g")
    )._to_abstract_repr(),
}


@pytest.mark.parametrize("name", list(OPERATOR_CASES))
def test_operator_parity(name):
    """TestTpuOperator, case by case."""
    assert_parity(OPERATOR_CASES[name], tol=TOL, message=MESSAGES.get(name))


def _n(ns, q):
    return _repr_op(ns, [(1.0, [({"rr": 1.0}, [q])])])


def _ghz(ns):
    return _amps_state(ns, {"gg": 1 / np.sqrt(2), "rr": 1 / np.sqrt(2)})


ABC_CASES = {
    "nonexistent_qubits": lambda ns: ns.pkg.backend.Operator._validate_operations(
        eigenstates=("r", "g"),
        n_qudits=2,
        operations=[(1.0, [({"gg": 1.0, "rr": -1.0}, {3, 5, 9})])],
    ),
    "reoccurring_qubit": lambda ns: ns.pkg.backend.Operator._validate_operations(
        eigenstates=("r", "g"),
        n_qudits=5,
        operations=[
            (
                1.0,
                [({"gg": 1.0, "rr": -1.0}, {2, 3}), ({"gg": 1.0, "rr": -1.0}, {3})],
            )
        ],
    ),
    "valid_operations": lambda ns: ns.pkg.backend.Operator._validate_operations(
        eigenstates=("r", "g"),
        n_qudits=5,
        operations=[
            (
                1.0,
                [({"gg": 1.0, "rr": -1.0}, {3}), ({"gg": 1.0, "rr": -1.0}, {1, 2})],
            )
        ],
    ),
    **{
        f"wrong_eigenstate_count-{len(e)}": (
            lambda ns, e=e: ns.pkg.backend.Operator._validate_operations(
                eigenstates=e,
                n_qudits=2,
                operations=[(1.0, [({"gggg": 1.0, "rr": -1.0}, {0})])],
            )
        )
        for e in [("r", "g"), ("r", "g", "x")]
    },
    "nonexistent_eigenstates": lambda ns: ns.pkg.backend.Operator._validate_operations(
        eigenstates=("r", "g"), n_qudits=2, operations=[(1.0, [({"hh": 1.0}, {0})])]
    ),
    **{
        f"bad_amplitudes-{i}": (
            lambda ns, a=a: ns.pkg.backend.State._validate_amplitudes(
                eigenstates=("r", "g"), amplitudes=a
            )
        )
        for i, a in enumerate([{"rrh": 1.0}, {"rr": 0.5, "rgg": math.sqrt(0.75)}])
    },
    "valid_amplitudes": lambda ns: ns.pkg.backend.State._validate_amplitudes(
        eigenstates=("r", "g", "x"),
        amplitudes={"rrgg": 0.5, "rggr": math.sqrt(0.75)},
    ),
    "validate_eigenstates-names": lambda ns: ns.pkg.backend.State._validate_eigenstates(
        eigenstates=["ground", "rydberg"]
    ),
    "validate_eigenstates-repeated": lambda ns: ns.pkg.backend.State._validate_eigenstates(
        eigenstates=["r", "g", "r"]
    ),
    "infer_one_state": lambda ns: [
        _amps_state(ns, {"gg": 1.0}).infer_one_state(),
        _amps_state(ns, {"dd": 1.0}, ("u", "d")).infer_one_state(),
    ],
    "add_and_scale": lambda ns: [
        (_n(ns, 0) + _n(ns, 1)).expect(_ghz(ns)),
        (2 * _n(ns, 0)).expect(_ghz(ns)),
    ],
    "matmul": lambda ns: [
        (_n(ns, 0) @ _n(ns, 1)).expect(_amps_state(ns, {"rr": 1.0})),
        (_n(ns, 0) @ _n(ns, 1)).expect(_amps_state(ns, {"gg": 1.0})),
    ],
    "apply_to": lambda ns: _repr_op(
        ns, [(1.0, [({"rg": 1.0, "gr": 1.0}, [0])])], n=1
    ).apply_to(_amps_state(ns, {"g": 1.0})).bitstring_probabilities(),
    "multi_qudit_tensor_op": lambda ns: _repr_op(
        ns, [(2.0, [({"rr": 1.0}, [0, 1, 2])])], n=3
    ).expect(_amps_state(ns, {"rrr": 1.0})),
    "repr_roundtrip_through_abstract-composed": lambda ns: (
        _n(ns, 0) + _n(ns, 1)
    )._to_abstract_repr(),
    "repr_roundtrip_through_abstract": lambda ns: _repr_op(
        ns, [(1.0, [({"rr": 1.0}, [0])]), (0.5, [({"rr": 1.0}, [1])])]
    )._to_abstract_repr(),
}


@pytest.mark.parametrize("name", list(ABC_CASES))
def test_state_operator_abc_parity(name):
    """The cases of tests/test_state_operator_abc.py."""
    assert_parity(ABC_CASES[name], tol=TOL)


# -- the term list against the dense product -------------------------


def _random_term_operator(rng, d, n, n_terms):
    eig = ("r", "g", "x")[:d]
    keys = [a + b for a in eig for b in eig]
    ops = []
    for _ in range(n_terms):
        support = rng.choice(n, size=rng.integers(0, min(n, 3) + 1), replace=False)
        tensor_op = [
            (
                {
                    k: complex(*rng.normal(size=2))
                    for k in rng.choice(keys, size=2, replace=False)
                },
                {int(q)},
            )
            for q in support
        ]
        ops.append((complex(*rng.normal(size=2)), tensor_op))
    return TorchOperator.from_operator_repr(
        eigenstates=eig, n_qudits=n, operations=ops
    )


def _random_state(rng, d, n, dm):
    dim = d**n
    psi = rng.normal(size=dim) + 1j * rng.normal(size=dim)
    psi /= np.linalg.norm(psi)
    if not dm:
        return psi
    a = rng.normal(size=(dim, 3)) + 1j * rng.normal(size=(dim, 3))
    rho = a @ a.conj().T
    return rho / np.trace(rho)


@pytest.mark.parametrize("dm", [False, True], ids=["ket", "dm"])
@pytest.mark.parametrize("d,n", [(2, 1), (2, 4), (2, 6), (3, 3)])
def test_terms_equal_dense_product(d, n, dm):
    """expect and apply_to, term by term, equal the dense to_qobj()
    product (complex128, 1e-12)."""
    rng = np.random.default_rng(100 * d + n + dm)
    op = _random_term_operator(rng, d, n, n_terms=4)
    assert op._dense is None and op._terms is not None
    dense = op.to_qobj().full()
    amps = _random_state(rng, d, n, dm)
    eig = op.eigenstates
    st = TorchState(torch.from_numpy(amps), eigenstates=eig)
    if dm:
        want_expect = np.trace(dense @ amps)
        want_apply = dense @ amps @ dense.conj().T
    else:
        want_expect = np.vdot(amps, dense @ amps)
        want_apply = dense @ amps
    got = op.expect(st)
    assert isinstance(got, complex)
    assert abs(got - want_expect) < TOL
    out = op.apply_to(st).to_tensor().numpy()
    assert np.max(np.abs(out - want_apply)) < TOL
    # The algebra keeps term lists, equal to the dense algebra
    other = _random_term_operator(rng, d, n, n_terms=2)
    combo = (0.5 - 1j) * (op + other) @ other
    assert combo._terms is not None
    want = (0.5 - 1j) * (dense + other.to_qobj().full()) @ other.to_qobj().full()
    assert np.max(np.abs(combo.to_qobj().full() - want)) < TOL


@pytest.mark.parametrize("n", [2, 5])
def test_hermitian_term_lists_expect_real(n):
    """A Hermitian term list returns a real expectation, as the JAX
    package's dense Hermiticity check would; a non-Hermitian one a
    complex value."""
    rng = np.random.default_rng(n)
    occ = TorchOperator.from_operator_repr(
        eigenstates=("r", "g"),
        n_qudits=n,
        operations=[
            (0.3, [({"rr": 1.0}, {0, n - 1})]),
            (1.0, [({"rg": 0.5 - 0.5j, "gr": 0.5 + 0.5j}, {1})]),
            (2.0, []),
        ],
    )
    lower = TorchOperator.from_operator_repr(
        eigenstates=("r", "g"), n_qudits=n, operations=[(1.0, [({"gr": 1.0}, {0})])]
    )
    st = TorchState(
        torch.from_numpy(_random_state(rng, 2, n, False)), eigenstates=("r", "g")
    )
    assert isinstance(occ.expect(st), float)
    assert isinstance(lower.expect(st), complex)
    assert isinstance((lower + lower.__rmul__(1)).expect(st), complex)
    dense = occ.to_qobj().full()
    assert np.allclose(dense, dense.conj().T)


def test_states_stay_on_their_device_and_compute_in_complex128():
    """A complex64 tensor stays as given; overlaps and expectations run
    in complex128 on its device."""
    psi = torch.tensor([0.6, 0.8j], dtype=torch.complex64)
    st = TorchState(psi, eigenstates=("r", "g"))
    assert st.to_tensor() is psi and st.torch_device.type == "cpu"
    z = TorchOperator(Qobj(np.diag([1.0, -1.0])), eigenstates=("r", "g"))
    assert z.expect(st) == pytest.approx(0.36 - 0.64, abs=1e-7)
    assert st.to_qobj().full().dtype == np.complex128
    assert issubclass(TorchState, State) and issubclass(TorchOperator, Operator)


@pytest.mark.parametrize("ns", [JAX, TORCH], ids=["jax", "torch"])
def test_number_operator_expect_matches_between_representations(ns):
    """The port's term list and the JAX package's dense matrix give the
    same occupation on a random 6-qubit state (complex128, 1e-12)."""
    rng = np.random.default_rng(6)
    amps = _random_state(rng, 2, 6, False)
    st = ns.State(ns.Qobj(amps), eigenstates=("r", "g"))
    op = _repr_op(ns, [(1.0, [({"rr": 1.0}, {2})])], n=6)
    occ = np.abs(amps.reshape(4, 2, 8)[:, 0, :]) ** 2
    assert abs(op.expect(st) - occ.sum()) < TOL
