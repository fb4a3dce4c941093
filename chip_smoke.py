"""Drives the PyTorch/CUDA port once on one NVIDIA GPU and checks it.

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``::

    python3 chip_smoke.py

On a host with several cards, ``python3 chip_smoke.py --across-cards``
runs only SHARD_STATE24 over NCCL, one rank a card (see
``_across_cards_phase``).

Phases (each one raises on failure, and the script then exits non-zero;
each main path builds its ``pulser_tpu_torch.Sequence`` with the same
calls as ``bench.py``, enters through ``TorchEmulator.from_sequence``,
and runs with every launch counter set to 0 just before it and read just
after; before it, a line gives the host time to build the sequence and
to sample it, median of 3 each, beside the card's name and power limit):

1. Require a CUDA device; print the card's name and power limit.
2. Build the four kernel sources with nvcc for ``sm_90a`` (one process
   per source, started together) and print the registers, shared memory
   and spills of each instantiation: the interaction-picture sesolve K1
   (``pulser_tpu_torch/csrc/ip_sesolve.cu``), its trajectory-batched mode
   with one block or one thread-block cluster per trajectory
   (``ip_sesolve_batched.cu``), the
   row-batched quantum-jump solve K2 (``mcwf_rows.cu``) and the lab-frame
   quantum-jump solve with general collapse operators K3 (``mcwf.cu``).
3. Hold K1 against its plain PyTorch version on random inputs at n = 10,
   13, 16 and 17 qubits (2 segments x 8 steps): max |Δ| ≤ 1e-5. Then its
   trajectory-batched mode at n = 10, 12, 13 (one block per trajectory),
   14 and 17 (one cluster per trajectory) with 3 trajectories of 2
   segments, drives, phase integrals and diagonals all different, and
   at n = 14, 15, 16 and 17 with 100 trajectories or, where more, one
   more than two waves of the clusters the card runs at once (2
   segments x 4 steps): max |Δ| ≤
   2e-5 and one device launch per batch by the library's count. For
   n = 14 to 17 the library's shape (blocks and threads a trajectory,
   shared memory, trajectories at once by the occupancy API) must be the
   wrapper's table's.
4. Hold K2 against its plain PyTorch version on random inputs at n = 1,
   2, 4, 7, 10, 11, 12 and 13 qubits, 8 trajectories (2 segments x 8
   steps, strong jumps; rotors carried in the first segment, recomputed
   in the second), and at n = 3, 10 and 12 with a jump after every step:
   max |Δ| ≤ 5e-5, finite, equal jump counts, and the kernel's count of
   carried rotors equal to the rows that agree bit for bit.
5. The same for K3 at n = 4, 7, 10 and 13 under strong general collapse
   operators whose G = Σ L†L has a non-zero off-diagonal.
6. Run the noiseless main path at full size: the 16-atom AFM sweep of
   ``bench.py`` through ``TorchEmulator.from_sequence(seq).run()`` with
   101 evaluation times. K1 must have been launched, and the mid-sweep
   and final states must reach 1 − F < 1e-6 against
   ``tests/goldens/afm16_final.npz``.
   Then time K1 against its plain version on the sweep's own inputs
   (median of 3 warm solves each) and the whole warm ``run()``, and
   count the device kernels one K1 solve launches (exactly one).
7. Run the noisy main path at full size: the 10-atom, 100-trajectory
   noisy run of ``bench.py`` through ``from_sequence(seq).run()`` after
   ``np.random.seed(1234)``. It must take the kernel route with at least
   one K2 launch and give 1000 shots per evaluation time; the final
   counts and the trajectory-averaged Rydberg populations must match the
   JAX package's figures for the same seed (:data:`NOISY10_REFERENCE`),
   and K2's states on the run's own inputs must match its plain version
   for all trajectories but at most one whose jump record differs.
8. Time K2 (median of 3), its plain version (once), the warm noisy
   ``run()``, the host preparation before the kernel, the staging of its
   inputs and the sampling epilogue (median of 3 each), count the device
   kernels one K2 solve launches (exactly one) and the steps whose rotor
   it carried over, and trace one warm noisy ``run()`` with
   ``torch.profiler`` for the device's busy share.
9. Run PAULI10, the lab-frame main path, at full size: the noisy 10-atom
   run plus the effective-noise Pauli channel (:func:`pauli10_sequence`),
   after ``np.random.seed(1234)``. It must take K3 (``kind ==
   "mcwf_cuda"``, at least one launch), give 1000 shots per evaluation
   time, and match the JAX package's figures for the same seed
   (``tests/goldens/noisy10_pauli_reference.json``): the per-trajectory
   final Rydberg populations within 1e-3 for all trajectories but at
   most one, the final counts within a total-variation distance of 0.02.
   K3's states on the run's own inputs must match its plain version for
   all trajectories but at most one whose jump record differs.
10. Time K3 (median of 3), its plain version (once), the warm PAULI10
    ``run()``, its host preparation, staging and host sampling, count
    the device kernels one K3 solve launches (exactly one), and trace
    one warm PAULI10 ``run()`` for the device's busy share.

11. Run SPD10, the noisy main path without collapse operators, at full
    size: the noisy 10-atom run with the dephasing taken out
    (:func:`spd10_sequence`), after ``np.random.seed(1234)``. It must take
    the trajectory-batched K1 (``kind == "ip_sesolve_batched_cuda"``, at
    least one launch), give 1000 shots per evaluation time, and match
    the JAX package's figures for the same seed
    (``tests/goldens/spd10_reference.json``): trajectory-averaged
    Rydberg populations within 1e-3, final counts within a
    total-variation distance of 0.02. The kernel's states on the run's
    own inputs must match its plain version per trajectory (max |Δ| ≤
    2e-5, 1 − F ≤ 1e-6).
12. Time the batched K1 (median of 3), its plain version (once), the
    warm SPD10 ``run()`` and its parts (host preparation, staging,
    fetch, result wrapping, host sampling), count the device kernels one
    batched solve launches (exactly one), and trace one warm SPD10
    ``run()`` for the device's busy share.

13. Run DEPH10, the master equation of one density matrix: the register
    and pulses of NOISY10 under dephasing alone (:func:`deph10_sequence`),
    through ``from_sequence(seq).run()``. It must take the master-equation
    route on the card (``kind == "mesolve_cuda"``, the interaction
    picture, the reference's step count), and the final ρ must have
    |tr − 1| ≤ 1e-5, be Hermitian within 1e-6, and match the JAX
    package's figures (``tests/goldens/deph10_reference.json``): Rydberg
    populations, diagonal and 64 off-diagonal elements within 1e-4. Time
    the warm ``run()`` (median of 3), the solve per RK4 stage, its kernel
    launches per stage, and the busy share from one trace.
14. Run MESOLVE10: NOISY10 with ``solver=Solver.MESOLVER``, 100 density
    matrices in one batched solve, after ``np.random.seed(1234)``. It must
    take the batched master-equation route (``kind ==
    "mesolve_batched_cuda"``), give 1000 shots per evaluation time, keep
    every trajectory's trace within 1e-5, and match trajectories 0-2 of the
    JAX package's batch (``tests/goldens/mesolve10_reference.json``) as in
    13. Time the cold ``run()``, one warm ``run()`` split into host prep,
    solve, wrapping and sampling, and the busy share from one trace.
15. Run EFF8, the lab-frame master equation with off-diagonal collapse
    operators (:func:`eff8_sequence`), and check and time it as in 13
    (``tests/goldens/eff8_reference.json``).
16. Run XY16 (:func:`xy16_sequence`), the lab-frame sesolve with the XY
    term and the SLM mask's interaction interpolation, 51 evaluation
    times. It must take the torch loop (``kind == "sesolve_torch_loop"``,
    ``ip`` false, the reference's step count); the final state must reach
    1 − F ≤ 1e-6 against ``tests/goldens/xy16_final.npz``, and the norm
    and the mean number of ``d`` excitations at every evaluation time
    must be within 1e-5 of the JAX package's. Time the warm ``run()`` and
    its solve (median of 3), and trace the solve's first 200 steps.
17. Run RELAX10 (:func:`relax10_sequence`) after
    ``np.random.seed(1234)``: the batched torch scan (``kind ==
    "mcwf_batched_torch"``, interaction picture, no kernel launched),
    1000 shots per evaluation time, the counts within TV 0.02 and the
    per-trajectory final Rydberg populations within 1e-3 (all but at most
    one trajectory) of ``tests/goldens/relax10_reference.json``. Time it
    as in 13, tracing one warm ``run()``.
18. Run MCDEPOL10 (:func:`mcdepol10_sequence`) with
    ``solver=Solver.MCSOLVER``, 100 trajectories, after
    ``np.random.seed(1234)``: the serial solve (``kind ==
    "mcwf_serial_torch"``, lab frame); the averaged final ρ must keep its
    trace within 1e-5, be Hermitian within 1e-6, and match the Rydberg
    populations of ``tests/goldens/mcdepol10_reference.json`` within 2e-2.
    Time it as in 16.

19. Run BACKEND_AFM16: the 16-atom sweep through the backend API,
    ``TorchBackendV2(seq, config=TorchConfig(observables=...)).run()``,
    with the state and the occupations at 101 relative times and the
    correlation matrix, the energy and 1000 shots at the end
    (:func:`_backend_afm16_observables`). One K1 launch; the final state
    within 1 − F < 1e-6 of the golden; the occupations within 1e-6 of the
    populations of ``run()``'s states at every time and within 1e-5 of
    the golden's at the end; the correlation matrix symmetric with the
    occupations on its diagonal; the energy within 1e-10 (relative) of
    ⟨ψ|H|ψ⟩ computed with ``hamiltonian_matvec`` on the run's final state,
    and from the same product on the golden state by no more than the
    state's distance to it allows (2‖δ‖‖Hψ‖ + ‖δ‖²‖H‖, ‖δ‖ ≤ √(2(1 − F)):
    the float32 solve misses the golden's energy by about 1e-5 of it); the
    shots within a total-variation distance of 0.01 of those drawn from
    the golden's probabilities with the same uniforms; the peak device memory
    under 2 GiB (no 2^16 × 2^16 matrix). Report the warm backend
    ``run()`` beside the emulator's (median of 3), the observables' host
    time and the device's busy share.
20. Run BACKEND_NOISY10: NOISY10 (:func:`noisy10_sequence`, 100
    trajectories, seed 1234) through ``TorchBackendV2`` with the
    occupations at 0.5 and 1.0, the energy, the state (aggregated into a
    1024 × 1024 ρ) and 1000 shots per trajectory at 1.0. One K2 launch;
    against the JAX package's backend run
    (``tests/goldens/backend_noisy10_reference.json``): occupations within
    1e-3, the energy within 1e-3 (relative), the counts within TV 0.02,
    ρ's trace within 1e-5 of 1, Hermitian within 1e-6, its diagonal within
    1e-3. Report the warm ``run()``, the observables' and the
    aggregation's host time, and the busy share.

21. Run TRI16 (:func:`tri16_sequence`): AFM16's pulses on the 16 atoms of
    ``AnalogDevice``'s calibrated ``TriangularLatticeLayout(61, 5)``
    (``hexagonal_register(16)``), designed on ``MockDevice`` and moved
    with ``seq.with_new_device(AnalogDevice)``. Its ``str`` and samples
    must equal, bit for bit, those of the same sweep built on
    ``AnalogDevice`` directly (:func:`tri16_direct_sequence`); it must take
    K1 (``kind == "ip_sesolve_cuda"``) in exactly one launch, by the
    wrapper's count and the C library's; its final state must be within
    1 − F ≤ 1e-12 of the direct build's and its mid-sweep and final states
    within 1 − F ≤ 1e-6 of ``tests/goldens/tri16_final.npz`` (the JAX
    package's own ``with_new_device``, ``tools/tri16_reference.py``). Then
    K1 against its plain version on TRI16's inputs, and the times. Its
    kernel entry follows AFM16's.
22. Run REGNOISE10 (:func:`regnoise10_sequence`: NOISY10 with register
    noise, σ_xy ≈ 0.29 µm, σ_z ≈ 1.51 µm) after ``np.random.seed(1234)``.
    It must take K2 (``kind == "mcwf_rows_cuda"``) in exactly one launch,
    hand it 100 distinct interaction diagonals (one per jittered
    trajectory, as the JAX package's batch has), give 1000 shots per
    evaluation time and match ``tests/goldens/regnoise10_reference.json``
    (``tools/regnoise10_reference.py``): trajectory-averaged Rydberg
    populations within 1e-3, final counts within TV 0.02. K2 against its
    plain version on the run's own inputs, the times and the busy share
    as in 8. Its kernel entry follows NOISY10's.

23. Run WIRE_AFM16: AFM16's sequence written with ``to_abstract_repr()``
    (its sha256 checked against :data:`WIRE_PAYLOAD_SHA256`, which
    ``tests/test_torch_json.py`` pins after validating the same payload),
    loaded back with ``Sequence.from_abstract_repr`` and run with
    ``TorchEmulator.from_sequence(...).run()``: samples bit-equal to the
    direct build's, one K1 launch by the wrapper's count and the C
    library's, 1 − F ≤ 1e-12 to the direct run's final state and ≤ 1e-6
    to the golden. Prints the host ms to write and to load the JSON.
24. Run WIRE_NOISY10: NOISY10's sequence and its ``EmulationConfig``
    (noise model, the serializable observables of BACKEND_NOISY10, 100
    trajectories) through ``to_abstract_repr`` / ``from_abstract_repr``,
    then ``TorchBackendV2(...).run()`` seeded with 1234: one K2 launch,
    occupations and counts equal to the same backend run built directly
    (max |Δ| 0, TV 0), and ``Results.to_abstract_repr()`` of the card's
    results loads back to equal values.
25. Run WIRE_TRI16: TRI16 submitted with ``QPUBackend(seq,
    connection=chip_connection()).run(job_params=[{"runs": 500}])``; the
    connection lists ``AnalogDevice`` decoded from its JSON, takes the
    measured sequence as JSON and, on fetch, decodes and emulates it on
    the card: one K1 launch, the counts equal to sampling the direct
    build's final state with the same seed.

26. Start the port's resident solve daemon on the card in a thread of
    this process (``serving.serve(path, device="cuda")``, AFM16's request
    as its warm request) and send it, through the port's ``SolveClient``,
    SERVE_AFM16 (AFM16's abstract repr, its final state only: 1 − F ≤ 1e-6
    to the golden, ≤ 1e-12 to this script's direct run, one K1 launch by
    the wrapper's and the C library's count, ``kind ==
    "ip_sesolve_cuda"``), SERVE_AFM16_ALL (all 101 states in one frame,
    each within 1 − F ≤ 1e-12 of the direct run's), SERVE_NOISY10
    (NOISY10's ``run_backend`` with :func:`wire_noisy10_config` and seed
    1234: occupations and counts equal to the direct backend run, one K2
    launch) and SERVE_TRI16 (500 shots seeded with 1234, equal to the
    direct build's, one K1 launch) (:func:`serve_requests`). Each warm
    request's wall time (median of 3) is split into the daemon's decode,
    solve and encode phases, and the daemon's ``profiling.phase_report()``
    of the requests is printed.
27. Two fresh processes, spawn to exit: (a) ``serving.py`` loaded by its
    path with ``torch`` and ``jax`` blocked sends SERVE_AFM16 to the warm
    daemon (1 − F ≤ 1e-6 to the golden); (b) ``import pulser_tpu_torch``
    and the same request run by ``TorchEmulator`` on the card.
28. ``SolveClient(...).ensure_server()`` spawns ``python -m
    pulser_tpu_torch.serving`` on the card: the time to its first ping,
    its first (cold) and second (warm) SERVE_AFM16, both equal to the
    in-process daemon's answer; after ``shutdown()`` it must exit with 0.
    Any failed check, any ``ok: false`` answer and any child exiting
    non-zero fails the script. K1's and K2's kernel entries list the
    launches on the served paths under ``also_on``.
29. The sharding phase (:func:`_sharding_phase`): rank processes spawned
    from this script (``pulser_tpu_torch.parallel.RankPool``: a
    ``FileStore`` in a temporary directory, one torch thread per rank,
    every rank's tensors on the card) run, through
    ``TorchEmulator.from_sequence``: SHARD_STATE24, the distributed
    demo's 24 atoms with the state over 2 gloo ranks (1 − F ≤ 1e-6 in
    complex128 to this process's unsharded solve, |norm − 1| ≤ 1e-5), and
    its twin over an explicit one-rank NCCL mesh (1 − F ≤ 1e-12);
    SHARD_NOISY10, NOISY10's trajectories over 2 ranks on the
    quantum-jump scan (populations within 1e-3 of
    :data:`NOISY10_REFERENCE`, counts within TV 0.02 of
    :data:`SHARD_NOISY10_REFERENCE`); SHARD_DEPH10, DEPH10's ρ rows over 2
    ranks (DEPH10's checks); SHARD2D_SPD10, SPD10 on a 2 × 2 trajectory ×
    state mesh (counts within TV 0.02 of SPD10's golden). Gloo moves host
    buffers, so the collectives on the card's tensors are staged through
    host memory (``parallel.comm.host_staged_collective``). Every case
    prints its ranks, backend, route, wall ms and the bytes a rank
    exchanged per RK4 stage and its peak device memory (SHARD_STATE24's
    must stay below the unsharded run's: a rank's share leaves the card
    before the ranks assemble the result); the ranks must agree bit for
    bit and load no JAX module; any failed rank fails the script. The ``paths`` entries
    gain the five cases.

30. The tutorials phase (:func:`_tutorials_phase`, after the paths of
    19-25): the six tutorials of ``docs/tutorials_torch`` run on the card
    through ``tools/build_tutorials_torch.py`` (``DEVICE = "cuda"``, into
    a temporary directory, every cell's assert held; without matplotlib
    on this host ``build_tutorials_torch``'s inert stand-in takes the
    drawing calls), each from the numpy seed of
    ``tests/goldens/tutorials_reference.json``
    (``tools/tutorial_references.py``: the JAX tutorials on a CPU), whose
    values they are held to: final states 1 − F ≤ 1e-6, ρ within 1e-4
    with |tr ρ − 1| ≤ 1e-5, populations within 1e-3, seeded counts
    within TV 0.02. TUT02's quantum-jump cell must launch K2 exactly once
    (the wrapper's and the C library's counts; K2's ``also_on``). Each
    tutorial's wall time and the phase's seconds are printed.
31. The scale phase (:func:`_scale_phase`): SCALE24, SCALE25 and SCALE26
    through ``tools/scale_ladder_torch.py``'s ``run_size`` (one card, the
    unsharded interaction-picture torch loop): |norm − 1| ≤ 1e-4, the
    peak device memory at most the capacity contract's ``solve_bytes``,
    1 − F ≤ 1e-6 against a complex128 solve of the same sequence on the
    card; then SCALE_CEIL, one cold solve at ``single_chip_ceiling(2,
    measured_memory_bytes())`` qubits (29 on an 80 GB card) with the norm
    and memory checks. Each case's ``paths`` entry has its wall, stages,
    ms per stage, peak memory, ``solve_bytes`` and route.

32. Run SPD16 (:func:`spd16_sequence`: the 16-atom AFM sweep under
    SPD10's noise, :data:`SPD16_RUNS` trajectories of 2^16 amplitudes)
    after
    ``np.random.seed(1234)`` and check and time it as SPD10 in 11 and 12
    (``tests/goldens/spd16_reference.json``,
    ``tools/spd16_reference.py``): K1's trajectory-batched mode, one
    thread-block cluster a trajectory, in exactly one launch; also the
    trajectories the card runs at once. SPD10's entry lists its
    launches under ``also_on``.
33. The shot sampler (:func:`_sampler_path`) on the batch of the
    benchmark's ``spd16.shots`` cell (SPD16 at 101 evaluation times): the
    route draws the shots on the card in one ``sample_states`` launch and
    fetches only the indices; the kernel on that batch against its plain
    version (the outcome indices, one for one), its time alone, the
    plain version's, and its bound (the batch's bytes read once). Its
    kernel entry comes last.

Phases 30 and 31 run after 25, before the serving phase; 32 and 33 run
after 10.

An earlier line names the JSON-schema validator the host has (the wire
paths validate every payload with it).

Every kernel also reports its time per RK4 stage; K1 also the cost of
its grid barrier alone (a cooperative launch of barriers only, on K1's
grid). The backend paths report their peak memory, their observables'
host time and their kernel launches in their ``paths`` entries. The
master-equation, XY and quantum-jump scan paths run torch operations
only (the JAX package computes them in XLA, outside any Pallas
kernel); they report their times, stages, ms and kernel launches per
stage, the bytes of the state and the device's busy share in the
``paths`` entry of the report.

Each kernel's line in the report gives the path it ran (``path``), its
launches on that path,
its error against its plain version there, its time and the plain
version's, and its bound: the larger of the float32 operations its
algorithm needs on this run's inputs over the H100's published float32
peak and the bytes of its inputs and outputs over the memory rate.

The line before the last is the kernel report, one JSON object; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
_GOLDEN = os.path.join(_ROOT, "tests", "goldens", "afm16_final.npz")
#: The JAX package's PAULI10 figures for seed 1234, printed by
#: ``JAX_PLATFORMS=cpu PYTHONPATH=. python tools/noisy10_pauli_reference.py``
#: (its vmapped XLA lab-frame scan on a CPU, single precision): the step
#: count, the per-trajectory final Rydberg population of each atom and
#: the final-time bitstring counts.
_PAULI10_GOLDEN = os.path.join(
    _ROOT, "tests", "goldens", "noisy10_pauli_reference.json"
)
#: The JAX package's SPD10 figures for seed 1234, printed by
#: ``JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spd10_reference.py`` (its
#: vmapped XLA batched sesolve on a CPU, single precision): the step
#: count, the final Rydberg population of each atom per trajectory and
#: averaged, and the final-time bitstring counts.
_SPD10_GOLDEN = os.path.join(_ROOT, "tests", "goldens", "spd10_reference.json")
#: The JAX package's SPD16 figures for seed 1234, printed by
#: ``JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spd16_reference.py`` (as
#: SPD10's, on the 16-atom sweep).
_SPD16_GOLDEN = os.path.join(_ROOT, "tests", "goldens", "spd16_reference.json")
#: The JAX package's master-equation figures (double precision, on a CPU),
#: written by ``JAX_PLATFORMS=cpu PYTHONPATH=. python
#: tools/mesolve_references.py``: the step count, the final ρ diagonal, the
#: per-atom Rydberg populations and 64 fixed off-diagonal elements of the
#: final ρ (MESOLVE10: of trajectories 0, 1 and 2 of the seeded batch).
_MESOLVE_GOLDENS = {
    name: os.path.join(_ROOT, "tests", "goldens", f"{name}_reference.json")
    for name in ("deph10", "mesolve10", "eff8")
}
#: The JAX package's XY16 run (double precision, on a CPU), written by
#: ``JAX_PLATFORMS=cpu PYTHONPATH=. python tools/xy_references.py``: the
#: final state, and the norm and mean number of ``d`` excitations at each
#: evaluation time.
_XY16_GOLDEN = os.path.join(_ROOT, "tests", "goldens", "xy16_final.npz")
#: The JAX package's TRI16 states (``tools/tri16_reference.py``) and its
#: REGNOISE10 figures for seed 1234 (``tools/regnoise10_reference.py``).
_TRI16_GOLDEN = os.path.join(_ROOT, "tests", "goldens", "tri16_final.npz")
_REGNOISE10_GOLDEN = os.path.join(
    _ROOT, "tests", "goldens", "regnoise10_reference.json"
)
#: TRI16 switched onto AnalogDevice against the same sweep built on it
#: directly: the same samples, so the same K1 solve (float32 on the card,
#: the two runs' rounding the same but for the order of host reductions).
SWITCH_FIDELITY_TOL = 1e-12
#: The JAX package's quantum-jump scans for seed 1234 (single precision,
#: on a CPU), written by ``JAX_PLATFORMS=cpu PYTHONPATH=. python
#: tools/mcwf_references.py``: RELAX10's step count, per-trajectory final
#: Rydberg populations and final counts; MCDEPOL10's step count and final
#: averaged ρ's Rydberg populations, diagonal and trace.
_MCWF_GOLDENS = {
    name: os.path.join(_ROOT, "tests", "goldens", f"{name}_reference.json")
    for name in ("relax10", "mcdepol10")
}

#: Tolerance of the kernel against its plain version on random inputs:
#: both run in float32 with different summation orders and libm.
KERNEL_TOL = 1e-5
#: The same over the whole 16-atom sweep (about a thousand RK4 steps of
#: float32 rounding, accumulated differently by the two versions).
SWEEP_TOL = 1e-4
#: Required agreement with the golden states.
FIDELITY_TOL = 1e-6
#: The trajectory-batched K1 against its plain version (as K1; the JAX
#: package's own batched-kernel test holds its kernel to the same).
BATCHED_TOL = 2e-5
#: K2 against its plain version (float32, different summation orders,
#: libm, and reductions; the phases reach ~100 rad).
MCWF_TOL = 5e-5
#: The noisy main path against the JAX package's figures: trajectory-
#: averaged Rydberg populations (absolute) and the total-variation
#: distance of the final 1000-shot count table.
POPULATION_TOL = 1e-3
COUNTS_TV_TOL = 0.02
#: The master-equation paths in complex64 against the JAX package's
#: complex128 figures: ρ elements and Rydberg populations (absolute), the
#: trace, and the Hermiticity of the final ρ.
RHO_TOL = 1e-4
TRACE_TOL = 1e-5
HERMITIAN_TOL = 1e-6
#: XY16 against the JAX package's double-precision run: the norm and the
#: mean number of d excitations at every evaluation time (both move by
#: the RK4 step's per-sector damping, identically in both packages).
XY_TOL = 1e-5
#: MCDEPOL10's averaged Rydberg populations against the JAX package's
#: (100 trajectories whose float32 jump times may differ by a step).
MC_POPULATION_TOL = 2e-2

#: The JAX package's run of the noisy 10-atom configuration after
#: ``np.random.seed(1234)`` (row-batched quantum-jump kernel, Pallas
#: interpreter on a CPU, single precision), printed by
#: ``JAX_PLATFORMS=cpu PYTHONPATH=. python tools/noisy10_reference.py``:
#: the per-atom Rydberg population at the final time, averaged over the
#: 100 trajectories, and the final-time bitstring counts.
NOISY10_REFERENCE = {
    "seed": 1234,
    "n_steps": 501,
    "rydberg_populations": [
        0.46465639132265646,
        0.29826585307028236,
        0.37574452470789965,
        0.30506157155183666,
        0.443851945939796,
        0.4584876543614119,
        0.29035249861616913,
        0.3839335009957779,
        0.2867389633681055,
        0.47287679161910917
    ],
    "final_counts": {
        "0000000101": 2,
        "0000001000": 1,
        "0000001010": 1,
        "0000010001": 2,
        "0000010011": 1,
        "0000010100": 1,
        "0000010101": 22,
        "0000100000": 1,
        "0000100010": 1,
        "0000101000": 1,
        "0000101010": 4,
        "0000110010": 13,
        "0000110100": 13,
        "0001000100": 1,
        "0001000101": 2,
        "0001001000": 1,
        "0001001001": 3,
        "0001010001": 4,
        "0001010100": 6,
        "0001010101": 56,
        "0001011100": 1,
        "0001011101": 1,
        "0001110101": 1,
        "0010000000": 1,
        "0010000001": 2,
        "0010000010": 1,
        "0010001001": 4,
        "0010001010": 2,
        "0010010000": 2,
        "0010010001": 10,
        "0010010010": 3,
        "0010010101": 1,
        "0010100010": 5,
        "0010101000": 3,
        "0010101010": 8,
        "0010110000": 17,
        "0010110001": 2,
        "0010110010": 18,
        "0010110011": 1,
        "0010110100": 1,
        "0011010100": 1,
        "0011010101": 1,
        "0011100000": 1,
        "0011110000": 1,
        "0011110010": 3,
        "0100000001": 2,
        "0100000101": 7,
        "0100010000": 3,
        "0100010001": 7,
        "0100010010": 6,
        "0100010100": 3,
        "0100010101": 44,
        "0100100010": 3,
        "0100100100": 3,
        "0100110000": 13,
        "0100110010": 28,
        "0100110011": 2,
        "0100110100": 38,
        "0100110101": 1,
        "0100111000": 1,
        "0100111010": 1,
        "0101000001": 1,
        "0101000100": 3,
        "0101000101": 9,
        "0101001100": 1,
        "0101001101": 1,
        "0101010000": 7,
        "0101010001": 51,
        "0101010011": 1,
        "0101010100": 5,
        "0101010101": 61,
        "0101010111": 2,
        "0101100101": 1,
        "0101110001": 1,
        "0101110100": 1,
        "0101110101": 1,
        "0111000101": 1,
        "0111010101": 1,
        "1000000000": 2,
        "1000000001": 1,
        "1000000100": 2,
        "1000000101": 23,
        "1000001000": 1,
        "1000001001": 12,
        "1000001010": 8,
        "1000100000": 3,
        "1000100010": 4,
        "1000100100": 9,
        "1000101000": 6,
        "1000101001": 1,
        "1000101010": 30,
        "1000101110": 1,
        "1000110000": 1,
        "1000110010": 1,
        "1001000000": 2,
        "1001000001": 10,
        "1001000100": 7,
        "1001000101": 38,
        "1001001000": 6,
        "1001001001": 25,
        "1001001101": 1,
        "1001011001": 1,
        "1001100010": 1,
        "1001100100": 1,
        "1001101010": 1,
        "1010000000": 4,
        "1010000001": 16,
        "1010000010": 10,
        "1010001000": 2,
        "1010001001": 29,
        "1010001010": 13,
        "1010001011": 1,
        "1010001101": 1,
        "1010100000": 21,
        "1010100010": 45,
        "1010100011": 1,
        "1010100110": 1,
        "1010101000": 50,
        "1010101010": 56,
        "1010101011": 1,
        "1010101100": 2,
        "1010101101": 1,
        "1010101110": 1,
        "1010111010": 3,
        "1011001001": 1,
        "1011101000": 1,
        "1011101010": 1,
        "1100010101": 1,
        "1100110100": 1,
        "1110001000": 1,
        "1110101010": 1
    },
}


def _sweep_sequence(
    register, omega: float, delta_0: float, delta_f: float,
    t_rise: int, t_sweep: int, t_fall: int, P=None, device=None,
):
    """A ramp-sweep-ramp ``Sequence`` on ``device``'s (default
    ``MockDevice``'s) global Rydberg channel, phase 0: an amplitude rise
    to ``omega`` at ``delta_0``, a detuning sweep to ``delta_f`` at
    ``omega``, an amplitude fall at ``delta_f`` (the ``Sequence`` calls of
    ``bench.py``), built with the package namespace ``P`` (default
    ``pulser_tpu_torch``)."""
    if P is None:
        import pulser_tpu_torch as P

    seq = P.Sequence(register, device or P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        P.Pulse.ConstantDetuning(
            P.RampWaveform(t_rise, 0.0, omega), delta_0, 0.0
        ),
        "ryd",
    )
    seq.add(
        P.Pulse.ConstantAmplitude(
            omega, P.RampWaveform(t_sweep, delta_0, delta_f), 0.0
        ),
        "ryd",
    )
    seq.add(
        P.Pulse.ConstantDetuning(
            P.RampWaveform(t_fall, omega, 0.0), delta_f, 0.0
        ),
        "ryd",
    )
    return seq


def _sampled(seq, *rest) -> tuple:
    """``(samples, register, device, *rest)`` of a built sequence."""
    from pulser_tpu_torch import sample

    return (sample(seq), seq.register, seq.device) + rest


#: AFM16's pulses: Ω = 2π·2, δ from −2π·6 to 2π·2, 252/2700/252 ns.
AFM16_SWEEP = (2.0 * 2 * np.pi, -6 * 2 * np.pi, 2 * 2 * np.pi, 252, 2700, 252)


def afm16_sequence(P=None):
    """The ``Sequence`` of the 16-atom AFM sweep.

    The configuration of ``bench.py``'s ``build_afm_sequence``: a 4x4
    square register at 6 µm on ``MockDevice``, one global Rydberg
    channel, a 252 ns amplitude rise at δ0 = −2π·6, a 2700 ns detuning
    sweep to δf = 2π·2 at Ω = 2π·2 and a 252 ns fall, phase 0. Built
    with the package namespace ``P`` (default ``pulser_tpu_torch``; the
    tests pass ``pulser_tpu`` for its reference), as every builder here.
    """
    if P is None:
        import pulser_tpu_torch as P

    return _sweep_sequence(
        P.Register.square(4, spacing=6.0, prefix="q"), *AFM16_SWEEP, P=P
    )


def afm16_inputs() -> tuple:
    """``(samples, register, device)`` of :func:`afm16_sequence`."""
    return _sampled(afm16_sequence())


def tri16_build(P, direct: bool = False):
    """The TRI16 ``Sequence`` built with the package namespace ``P``
    (``pulser_tpu_torch``, or ``pulser_tpu`` for its reference): the 16
    atoms of ``hexagonal_register(16)`` on ``AnalogDevice``'s calibrated
    ``TriangularLatticeLayout(61, 5)`` (a triangular lattice at 5 µm) under
    AFM16's pulses, built on ``MockDevice`` and moved with
    ``seq.with_new_device(AnalogDevice)``, the usual way to submit a
    sequence; with ``direct``, built on ``AnalogDevice`` itself."""
    reg = P.AnalogDevice.pre_calibrated_layouts[0].hexagonal_register(16)
    if direct:
        return _sweep_sequence(reg, *AFM16_SWEEP, P=P, device=P.AnalogDevice)
    seq = _sweep_sequence(reg, *AFM16_SWEEP, P=P)
    with warnings.catch_warnings():
        # The Rydberg level changes (70 on MockDevice, 60 on AnalogDevice)
        warnings.filterwarnings("ignore", "Switching to a device with a")
        return seq.with_new_device(P.AnalogDevice)


def tri16_sequence():
    """The ``pulser_tpu_torch.Sequence`` of TRI16, switched onto
    ``AnalogDevice`` (:func:`tri16_build`)."""
    import pulser_tpu_torch

    return tri16_build(pulser_tpu_torch)


def tri16_direct_sequence():
    """TRI16 built on ``AnalogDevice`` directly (:func:`tri16_build`)."""
    import pulser_tpu_torch

    return tri16_build(pulser_tpu_torch, direct=True)


#: The noise of the noisy 10-atom run (``bench.py::build_noisy_10atom``).
_NOISY10_NOISE = dict(
    state_prep_error=0.005,
    p_false_pos=0.01,
    p_false_neg=0.02,
    temperature=50.0,
    amp_sigma=0.02,
    laser_waist=175.0,
    dephasing_rate=0.05,
    runs=100,
    samples_per_run=10,
)
#: Pulser's effective-noise Pauli channel: X, Y, Z at 0.0125 /µs each
#: (the Lindblad content of a 0.05 /µs depolarizing rate), in the
#: ground-rydberg basis order (|r> first).
PAULI_RATE = 0.0125
PAULIS = (
    ((0, 1), (1, 0)),
    ((0, -1j), (1j, 0)),
    ((1, 0), (0, -1)),
)


def _noisy10(dephasing: bool = True, P=None, **extra) -> tuple:
    if P is None:
        import pulser_tpu_torch as P

    params = dict(_NOISY10_NOISE)
    if not dephasing:
        del params["dephasing_rate"]
    om = 2 * np.pi * 1.5
    seq = _sweep_sequence(
        P.Register.rectangle(2, 5, spacing=7.0, prefix="q"),
        om, -2 * np.pi * 4, 2 * np.pi * 2, 400, 1200, 400, P=P,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # runs=
        noise = P.NoiseModel(**params, **extra)
    return seq, noise


def noisy10_sequence(P=None) -> tuple:
    """``(sequence, noise_model)`` of the noisy run.

    The configuration of ``bench.py``'s ``build_noisy_10atom`` (the
    BASELINE's noisy leg): a 2x5 rectangle at 7 µm on ``MockDevice``, a
    400 ns amplitude rise to Ω = 2π·1.5 at δ = −2π·4, a 1200 ns sweep to
    δ = 2π·2 and a 400 ns fall; SPAM (prep 0.005, false positive 0.01,
    false negative 0.02), doppler at 50 µK, amplitude noise (σ = 0.02,
    laser waist 175 µm) and dephasing at 0.05 /µs, 100 trajectories of
    10 samples each.
    """
    return _noisy10(P=P)


def noisy10_inputs() -> tuple:
    """``(samples, register, device, noise_model)`` of
    :func:`noisy10_sequence`."""
    return _sampled(*noisy10_sequence())


#: The register noise REGNOISE10 adds to NOISY10: traps of waist 1 µm and
#: depth 150 µK at NOISY10's 50 µK, so σ_xy ≈ 0.29 µm in the plane and
#: σ_z ≈ 1.51 µm along the trap axis.
REGNOISE10_TRAP = dict(trap_waist=1.0, trap_depth=150.0)


def regnoise10_sequence(P=None) -> tuple:
    """``(sequence, noise_model)`` of REGNOISE10: NOISY10
    (:func:`noisy10_sequence`) with register noise added
    (:data:`REGNOISE10_TRAP`). Each trajectory's atoms are jittered in
    three dimensions, so each of the 100 trajectories has its own
    interaction diagonal and laser-waist profile."""
    return _noisy10(P=P, **REGNOISE10_TRAP)


def pauli10_sequence(P=None) -> tuple:
    """``(sequence, noise_model)`` of the PAULI10 run:
    the noisy 10-atom run of :func:`noisy10_sequence` plus the effective-
    noise Pauli channel (:data:`PAULIS` at :data:`PAULI_RATE` each). Its
    collapse operators are not diagonal, so the quantum-jump solve runs
    in the lab frame, 4000 RK4 steps."""
    return _noisy10(
        P=P,
        eff_noise_rates=[PAULI_RATE] * 3,
        eff_noise_opers=[np.array(p, dtype=complex) for p in PAULIS],
    )


def pauli10_inputs() -> tuple:
    """``(samples, register, device, noise_model)`` of
    :func:`pauli10_sequence`."""
    return _sampled(*pauli10_sequence())


def spd10_sequence(P=None) -> tuple:
    """``(sequence, noise_model)`` of the SPD10 run: the
    noisy 10-atom run of :func:`noisy10_sequence` with the dephasing taken
    out and nothing else changed (SPAM, doppler, amplitude noise). It
    has no collapse operators, so the 100 trajectories integrate as one
    pure-state batch on the coarsened interaction-picture grid."""
    return _noisy10(dephasing=False, P=P)


def spd10_inputs() -> tuple:
    """``(samples, register, device, noise_model)`` of
    :func:`spd10_sequence`."""
    return _sampled(*spd10_sequence())


#: SPD16's trajectories. The JAX package's reference of 100 (its vmapped
#: XLA scan over 100 × 2^16 amplitudes on a CPU) does not finish in 90
#: minutes, so the golden and the card's run both take 20 trajectories of
#: 50 samples: the same 1000 shots as SPD10's 100 of 10.
SPD16_RUNS = 20


def spd16_sequence(P=None, runs: int = SPD16_RUNS) -> tuple:
    """``(sequence, noise_model)`` of the SPD16 run: the 16-atom AFM
    sweep of :func:`afm16_sequence` under SPD10's noise (SPAM, doppler at
    50 µK, amplitude σ 0.02 with a 175 µm waist; no dephasing), ``runs``
    trajectories of ``1000 // runs`` samples. It has no collapse
    operators, so the trajectories integrate as one pure-state batch of
    2^16 amplitudes each on the interaction-picture grid."""
    if P is None:
        import pulser_tpu_torch as P

    params = dict(_NOISY10_NOISE, runs=runs, samples_per_run=1000 // runs)
    del params["dephasing_rate"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # runs=
        noise = P.NoiseModel(**params)
    return afm16_sequence(P), noise


def deph10_sequence(P=None) -> tuple:
    """``(sequence, noise_model)`` of DEPH10: the register and pulses of
    :func:`noisy10_sequence` (2x5 at 7 µm, 400/1200/400 ns) under
    dephasing at 0.05 /µs alone. Without shot-to-shot noise the default
    solver runs one master-equation solve of the 1024 x 1024 density
    matrix on the coarsened interaction-picture grid."""
    if P is None:
        import pulser_tpu_torch as P

    return _noisy10(P=P)[0], P.NoiseModel(dephasing_rate=0.05)


def mesolve10_sequence(P=None) -> tuple:
    """``(sequence, noise_model)`` of MESOLVE10: NOISY10 exactly
    (:func:`noisy10_sequence`), run with ``solver=Solver.MESOLVER``: one
    density matrix per noise trajectory, 100 trajectories, in one batched
    master-equation solve on the interaction-picture grid."""
    return noisy10_sequence(P)


def eff8_sequence(P=None) -> tuple:
    """``(sequence, noise_model)`` of EFF8: the sweep of
    :func:`noisy10_sequence` on a 2x4 rectangle at 7 µm under PAULI10's
    effective-noise Pauli channel alone (no shot-to-shot noise). The Pauli
    operators are not diagonal, so the master equation runs in the lab
    frame. Eight atoms, so that the JAX package's reference finishes on a
    CPU (``tools/mesolve_references.py``)."""
    if P is None:
        import pulser_tpu_torch as P

    om = 2 * np.pi * 1.5
    seq = _sweep_sequence(
        P.Register.rectangle(2, 4, spacing=7.0, prefix="q"),
        om, -2 * np.pi * 4, 2 * np.pi * 2, 400, 1200, 400, P=P,
    )
    noise = P.NoiseModel(
        eff_noise_rates=[PAULI_RATE] * 3,
        eff_noise_opers=[np.array(p, dtype=complex) for p in PAULIS],
    )
    return seq, noise


def relax10_sequence(P=None) -> tuple:
    """``(sequence, noise_model)`` of RELAX10: NOISY10
    (:func:`noisy10_sequence`) plus relaxation at 0.1 /µs, the dephasing
    kept. Relaxation is a single matrix unit, so the 100 quantum-jump
    trajectories run the batched torch scan on the interaction-picture
    grid (no kernel takes a non-diagonal operator there)."""
    return _noisy10(P=P, relaxation_rate=0.1)


def mcdepol10_sequence(P=None) -> tuple:
    """``(sequence, noise_model)`` of MCDEPOL10: NOISY10's register and
    pulses under depolarizing noise at 0.05 /µs alone, run with
    ``solver=Solver.MCSOLVER`` and ``n_trajectories=100``: one serial
    quantum-jump solve in the lab frame whose trajectories average into
    density matrices."""
    if P is None:
        import pulser_tpu_torch as P

    return _noisy10(P=P)[0], P.NoiseModel(depolarizing_rate=0.05)


def xy16_build(P):
    """The XY16 ``Sequence`` built with the package namespace ``P``
    (``pulser_tpu_torch``, or ``pulser_tpu`` for its reference): Pulser's
    state preparation with the SLM mask in XY mode. A 4x4 square at 10 µm
    on ``MockDevice``, the magnetic field along z (30 G), the ``mw_global``
    channel, the mask on the 8 atoms of one checkerboard colour, a 48 ns
    π pulse the mask holds off the masked atoms, then 1000 ns of free
    exchange."""
    reg = P.Register.square(4, spacing=10.0, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.set_magnetic_field(0.0, 0.0, 30.0)
    seq.declare_channel("mw", "mw_global")
    seq.config_slm_mask(
        [f"q{i}" for i in range(16) if (i // 4 + i % 4) % 2 == 0]
    )
    seq.add(P.Pulse.ConstantPulse(48, np.pi / 0.048, 0.0, 0.0), "mw")
    seq.add(P.Pulse.ConstantPulse(1000, 0.0, 0.0, 0.0), "mw")
    return seq


def xy16_sequence():
    """The ``pulser_tpu_torch.Sequence`` of XY16 (:func:`xy16_build`)."""
    import pulser_tpu_torch

    return xy16_build(pulser_tpu_torch)


#: XY16's 51 evaluation times (µs), on the nanosecond grid of the samples.
XY16_EVAL_TIMES = np.round(np.linspace(0, 1048, 51)) / 1000


def _sequence_ms(path: str, make_sequence, card: str) -> None:
    """Prints the host time to build ``path``'s sequence and to sample it
    as ``from_sequence`` does (median of 3 each), beside the card."""
    from pulser_tpu_torch import sample

    seq = make_sequence()
    build_s = _median_seconds(make_sequence)
    sample_s = _median_seconds(
        lambda: sample(seq, extended_duration=seq.get_duration())
    )
    print(
        f"{path} sequence: build {build_s * 1e3:.3f} ms, "
        f"sample {sample_s * 1e3:.3f} ms (host, median of 3) [{card}]",
        flush=True,
    )


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _fidelity(golden: np.ndarray, state: np.ndarray) -> float:
    a = golden / np.linalg.norm(golden)
    b = state / np.linalg.norm(state)
    return float(abs(np.vdot(a, b)) ** 2)


def random_kernel_inputs(
    n: int, seed: int, device, seg_len: int = 8
) -> tuple:
    """Random ip_sesolve inputs for 2 segments of ``seg_len`` steps on n
    qubits, made with numpy from ``seed``: ``(tensors, keywords)``."""
    import torch

    rng = np.random.default_rng(seed)
    n_col = 8 if n >= 15 else 7
    n_row = n - n_col
    rows, cols = 1 << n_row, 1 << n_col
    n_seg = 2
    stage = (n_seg, seg_len, 3, n)
    dts = rng.uniform(1e-3, 4e-3, (n_seg, seg_len, 1))
    dts[1, :2] = 0.0  # start padding of a short segment
    # Stage times on one grid, as build_plan makes them: a step's last
    # row and the next step's first are the same time
    grid = np.concatenate([[0.0], np.cumsum(dts.reshape(-1))])
    t_stage = np.stack(
        [grid[:-1], 0.5 * (grid[:-1] + grid[1:]), grid[1:]], axis=-1
    ).reshape(n_seg, seg_len, 3)
    # Phase integrals continuous across the steps of segment 0 (the
    # kernel carries its end-of-step rotor there) and independent in
    # segment 1 (it recomputes)
    cum = rng.uniform(0.0, 2 * np.pi, stage)
    cum[0, 1:, 0] = cum[0, :-1, 2]
    psi0 = rng.normal(size=(2, rows, cols))
    psi0 /= np.linalg.norm(psi0)
    host = [
        rng.uniform(-6.0, 6.0, stage),
        rng.uniform(-6.0, 6.0, stage),
        cum,
        t_stage,
        dts,
        t_stage[:, -1, 2].reshape(n_seg, 1, 1),
        rng.uniform(0.0, 2 * np.pi, (n_seg, 1, n)),
        rng.uniform(0.0, 400.0, (1, rows, cols)),
        psi0[0],
        psi0[1],
    ]
    tensors = [
        torch.from_numpy(np.ascontiguousarray(h, dtype=np.float32)).to(device)
        for h in host
    ]
    return tensors, dict(n_row=n_row, n_col=n_col, seg_len=seg_len)


def random_batched_kernel_inputs(
    n: int, seed: int, device, n_traj: int = 3, seg_len: int = 8,
    n_seg: int = 2,
) -> tuple:
    """Random inputs of the trajectory-batched ip_sesolve, made with numpy
    from ``seed``, in the layout of the JAX package's ``_ip_sesolve_jit``
    with ``segs_per_traj = n_seg``: ``n_traj`` trajectories of ``n_seg``
    segments of ``seg_len`` steps, trajectory-major; ``(tensors,
    keywords)``. The grid is shared (tiled per trajectory; the last
    segment starts with 2 padding steps); drives, phase integrals and
    diagonals differ between the trajectories, so a missed reset or a
    wrong diagonal shows. The phase integrals are continuous across the
    steps of each trajectory's first segment (the kernel carries its
    end-of-step rotor there) and independent elsewhere (it recomputes)."""
    import torch

    rng = np.random.default_rng(seed)
    n_col = 8 if n >= 15 else 7
    n_row = n - n_col
    rows, cols = 1 << n_row, 1 << n_col
    stage = (n_traj, n_seg, seg_len, 3, n)
    dts = rng.uniform(1e-3, 4e-3, (n_seg, seg_len, 1))
    dts[-1, :2] = 0.0  # start padding of a short segment
    grid = np.concatenate([[0.0], np.cumsum(dts.reshape(-1))])
    t_stage = np.stack(
        [grid[:-1], 0.5 * (grid[:-1] + grid[1:]), grid[1:]], axis=-1
    ).reshape(n_seg, seg_len, 3)
    cum = rng.uniform(0.0, 2 * np.pi, stage)
    cum[:, 0, 1:, 0] = cum[:, 0, :-1, 2]
    psi0 = rng.normal(size=(2, rows, cols))
    psi0 /= np.linalg.norm(psi0)
    flat = (n_traj * n_seg,)

    def tiled(x: np.ndarray) -> np.ndarray:
        return np.tile(x, (n_traj,) + (1,) * (x.ndim - 1))

    host = [
        rng.uniform(-6.0, 6.0, stage).reshape(flat + stage[2:]),
        rng.uniform(-6.0, 6.0, stage).reshape(flat + stage[2:]),
        cum.reshape(flat + stage[2:]),
        tiled(t_stage),
        tiled(dts),
        tiled(t_stage[:, -1, 2].reshape(n_seg, 1, 1)),
        rng.uniform(0.0, 2 * np.pi, flat + (1, n)),
        rng.uniform(0.0, 400.0, (n_traj, rows, cols)),
        psi0[0],
        psi0[1],
    ]
    tensors = [
        torch.from_numpy(np.ascontiguousarray(h, dtype=np.float32)).to(device)
        for h in host
    ]
    return tensors, dict(
        n_row=n_row, n_col=n_col, seg_len=seg_len, segs_per_traj=n_seg
    )


def random_sample_inputs(
    n: int, seed: int, device, n_traj: int = 3, n_seg: int = 4,
    shots: int = 60,
) -> tuple:
    """Random inputs of ``kernels.sample_states``, made with numpy from
    ``seed``: ``(planes, seg_of, offs, u)`` on ``device``. ``n_traj``
    trajectories of ``n_seg`` segments of 2^n float32 amplitudes, a few
    percent off their norm; trajectory 0 is a peaked AFM-like state (the
    two Néel states hold most of the weight) and every state has zero
    amplitudes at both ends of its index range, so a row's weights start
    and end with zeros in either bit order. Five evaluation times read
    segments ``(0, 2, 2, 1, n_seg - 1)``; entry e draws ``shots + e % 3``
    uniforms, the last of each 1 − 2^-53, above a row's total when it
    rounds below 1."""
    import torch

    rng = np.random.default_rng(seed)
    dim = 1 << n
    planes = rng.standard_normal((n_traj, n_seg, 2, dim))
    planes /= np.sqrt((planes**2).sum(axis=(2, 3), keepdims=True))
    planes *= rng.uniform(0.97, 1.03, (n_traj, n_seg, 1, 1))
    neel = [int("01" * (n // 2), 2), int("10" * (n // 2), 2)]
    planes[0] *= 0.01
    planes[0, :, 0, neel] = 0.7
    planes[..., :3] = planes[..., -5:] = 0.0
    seg_of = np.array([0, 2, 2, 1, n_seg - 1], dtype=np.int64) % n_seg
    ns = [shots + e % 3 for e in range(n_traj * len(seg_of))]
    offs = np.concatenate(([0], np.cumsum(ns))).astype(np.int64)
    u = rng.random(int(offs[-1]))
    u[offs[1:] - 1] = 1.0 - 2.0**-53
    return tuple(
        torch.from_numpy(np.ascontiguousarray(x)).to(device)
        for x in (planes.astype(np.float32), seg_of, offs, u)
    )


#: Diagonal collapse operators of the random K2 inputs, (l00_re, l00_im,
#: l11_re, l11_im) each: a Z-like and a strong Rydberg-decay-like channel,
#: so that trajectories jump within a few steps.
RANDOM_COPS = ((0.3, 0.0, -0.3, 0.0), (0.0, 0.0, 2.5, 0.5))


def random_mcwf_inputs(
    n: int, seed: int, device, n_traj: int = 8, seg_len: int = 8,
    threshold: float = 0.9, plan_like: bool = True,
) -> list:
    """Random mcwf_rows inputs, made with numpy from ``seed``, in the
    layout of the JAX package's ``mcwf_rows_program``: 2 segments of
    ``seg_len`` steps (the second starts with 2 padding steps). The
    jump thresholds are drawn in ``[threshold, 1]``, near 1 so that
    trajectories jump early (at 1, after every step). With ``plan_like``
    the stage times lie on one grid and the phase integrals are
    continuous across the steps of segment 0, as a plan makes them (the
    kernel carries its end-of-step rotor there) and independent in
    segment 1 (it recomputes); without it no two rows agree."""
    import torch

    rng = np.random.default_rng(seed)
    n_seg, dim = 2, 1 << n
    stage = (n_traj, n_seg, seg_len, 3, 1, n)
    dts = rng.uniform(2e-3, 6e-3, (n_seg, seg_len))
    dts[1, :2] = 0.0
    if plan_like:
        grid = np.concatenate([[0.0], np.cumsum(dts.reshape(-1))])
        t_stage = np.stack(
            [grid[:-1], 0.5 * (grid[:-1] + grid[1:]), grid[1:]], axis=-1
        ).reshape(n_seg, seg_len, 3)
    else:
        t0 = np.cumsum(dts.reshape(-1)).reshape(n_seg, seg_len) - dts
        t_stage = t0[..., None] + dts[..., None] * np.array([0.0, 0.5, 1.0])
    us = rng.uniform(0.0, 1.0, (n_traj, n_seg, seg_len, 2))
    us[..., 1] = rng.uniform(threshold, 1.0, us.shape[:-1])
    psi0 = rng.normal(size=(2, dim))
    psi0 /= np.linalg.norm(psi0)
    a_re = rng.uniform(-6.0, 6.0, stage)
    a_im = rng.uniform(-6.0, 6.0, stage)
    cum = rng.uniform(0.0, 2 * np.pi, stage)
    if plan_like:
        cum[:, 0, 1:, 0] = cum[:, 0, :-1, 2]
    host = [
        a_re,
        a_im,
        cum,
        t_stage,
        dts,
        us,
        t_stage[:, -1, 2],
        rng.uniform(0.0, 2 * np.pi, (n_traj, n_seg, 1, n)),
        rng.uniform(threshold, 1.0, n_traj),
        rng.uniform(0.0, 400.0, (n_traj, dim)),
        psi0[0],
        psi0[1],
    ]
    return [
        torch.from_numpy(np.ascontiguousarray(h, dtype=np.float32)).to(device)
        for h in host
    ]


#: General collapse operators of the random K3 inputs, as 2×2 complex
#: matrices: a strong complex operator whose G = Σ L†L has a non-zero
#: off-diagonal, and a Pauli-X-like flip, so that trajectories jump within
#: a few steps and the non-Hermitian flip entries carry G[1, 0].
RANDOM_GENERAL_COPS = (
    ((0.4, 1.1 + 0.5j), (0.3 - 0.6j, -0.2 + 0.3j)),
    ((0.0, 0.7), (0.7, 0.0)),
)


def random_k3_inputs(
    n: int, seed: int, device, n_traj: int = 8, seg_len: int = 8,
    threshold: float = 0.9,
) -> tuple:
    """Random K3 inputs, made with numpy from ``seed``, in the layout of
    the JAX package's ``_mcwf_jit``: ``n_traj`` trajectories of 2
    segments of ``seg_len`` steps (the second starts with 2 padding
    steps), under :data:`RANDOM_GENERAL_COPS`. The jump thresholds are
    drawn in ``[threshold, 1]``, near 1 so that trajectories jump early
    (at 1, after every step). Returns ``(tensors, keywords)``."""
    import torch

    from pulser_tpu_torch.ops.solver import _general_cops_spec

    rng = np.random.default_rng(seed)
    n_seg, n_col = 2, min(7, n - 1)
    n_row = n - n_col
    rows, cols = 1 << n_row, 1 << n_col
    stage = (n_traj * n_seg, seg_len, 3, n)
    dts = rng.uniform(2e-3, 6e-3, (n_seg, seg_len))
    dts[1, :2] = 0.0
    us = rng.uniform(0.0, 1.0, (n_traj * n_seg, seg_len, 2))
    us[..., 1] = rng.uniform(threshold, 1.0, us.shape[:-1])
    psi0 = rng.normal(size=(2, rows, cols))
    psi0 /= np.linalg.norm(psi0)
    host = [
        rng.uniform(-6.0, 6.0, stage),
        rng.uniform(-6.0, 6.0, stage),
        rng.uniform(-40.0, 40.0, stage),
        np.tile(dts[..., None], (n_traj, 1, 1)),
        us,
        rng.uniform(threshold, 1.0, (n_traj, 1)),
        rng.uniform(0.0, 400.0, (n_traj, rows, cols)),
        psi0[0],
        psi0[1],
    ]
    tensors = [
        torch.from_numpy(np.ascontiguousarray(h, dtype=np.float32)).to(device)
        for h in host
    ]
    kw = dict(
        n_row=n_row, n_col=n_col, seg_len=seg_len, segs_per_traj=n_seg,
        **_general_cops_spec(RANDOM_GENERAL_COPS),
    )
    return tensors, kw


def _median_seconds(fn, repeats: int = 3) -> float:
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _tv_distance(a: dict, b: dict) -> float:
    """Total-variation distance of two bitstring count tables."""
    na, nb = sum(a.values()), sum(b.values())
    return 0.5 * sum(
        abs(a.get(k, 0) / na - b.get(k, 0) / nb) for k in set(a) | set(b)
    )


def _rydberg_populations(probs: np.ndarray, n: int) -> np.ndarray:
    """Per-trajectory Rydberg population of each atom, ``(B, n)``, from
    ``(B, 2^n)`` probabilities (|r> is bit n-1-q == 0)."""
    idx = np.arange(probs.shape[1])
    ryd = np.stack([((idx >> (n - 1 - q)) & 1) == 0 for q in range(n)])
    return probs @ ryd.T.astype(float)


def _plane_probs(states) -> np.ndarray:
    """``(B, 2^n)`` probabilities of ``(B, 2, 2^n)`` real/imaginary
    planes."""
    st = states.double().cpu().numpy()
    return st[:, 0] ** 2 + st[:, 1] ** 2


#: The wrappers' launch counts (``pulser_tpu_torch.ops.kernels.launches``)
#: at the last :func:`_reset_launches`.
_LAUNCHES_AT_RESET: dict = {}


def _reset_launches(K) -> None:
    _LAUNCHES_AT_RESET.update({name: K.launches(name) for name in K.SOURCES})


def _launches(K) -> dict:
    """The wrappers' launches by kernel since :func:`_reset_launches`."""
    return {
        name: K.launches(name) - _LAUNCHES_AT_RESET.get(name, 0)
        for name in K.SOURCES
    }


#: Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W):
#: float32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _ops_per_amp_stage(kernel: str, n: int) -> int:
    """The float32 operations one RK4 stage needs per amplitude, counting
    a sin or cos as one: each stage gathers n flip partners (a complex
    multiply-add, 8 operations each, plus the detuning projector's n
    conditional adds in the lab frame) and updates the stage input and
    the accumulator (8). The interaction-picture kernels add the rotor
    (phase n + 3, sin and cos, two complex rotations: n + 17); K2 adds the
    decay −½g·x (7); K3 adds the lab-frame diagonal with its imaginary
    part (13)."""
    return {
        "ip_sesolve": 9 * n + 25,
        "ip_sesolve_batched": 9 * n + 25,
        "mcwf_rows": 9 * n + 32,
        "mcwf": 9 * n + 21,
    }[kernel]


def _bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """The least time in ms the card could take for the work: the larger
    of the operations over the float32 peak and the bytes (each input
    read once, each output written once) over the memory rate."""
    t_ops = flops / PEAK_F32_FLOPS
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops >= t_bytes else "bytes"
    )


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


#: Names of the CUDA runtime and driver calls that launch a kernel, as
#: ``torch.profiler`` records them on the host.
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")


def _device_busy(fn) -> tuple[float, float, int]:
    """Wall seconds of one traced call of ``fn``, the device's busy
    milliseconds in it (kernels and copies; the emulator's
    record_function ranges show as device events too and are left out),
    and its kernel launches: the host-side launch calls of the trace,
    which it records even when it catches no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # one-cycle profiler
        with profile(activities=activities) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(
        e.self_device_time_total
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.is_user_annotation
    )
    launches = sum(e.count for e in events if e.key in _LAUNCH_CALLS)
    return wall_s, busy_us / 1e3, launches


def _print_busy(what: str, wall_s: float, busy_ms: float) -> None:
    print(
        f"profiled {what}: {wall_s * 1e3:.3f} ms wall, device busy"
        f" {busy_ms:.3f} ms ({100 * busy_ms / 1e3 / wall_s:.1f}%)"
    )


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel instantiation of an ``nvcc -Xptxas
    -v`` log: its template arguments, registers, shared memory and
    spills."""
    lines, name, spills = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            kernel = re.search(
                r"(ip_sesolve_kernel|ip_sesolve_batched_kernel"
                r"|barrier_probe_kernel|mcwf_rows_kernel|mcwf_kernel"
                r"|sample_states_kernel)",
                mangled,
            )
            args = re.findall(r"L[ib](\d+)E", mangled)
            name = (kernel.group(1) if kernel else mangled) + (
                f"<{','.join(args)}>" if args else ""
            )
            continue
        spill = re.search(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", line
        )
        if spill:
            spills = f"spills {spill.group(1)}/{spill.group(2)} B"
        used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if used and name is not None:
            lines.append(
                f"{name}: {used.group(1)} registers,"
                f" {used.group(2) or 0} B static smem, {spills}"
            )
            name, spills = None, ""
    return lines


def _build(K) -> None:
    """Builds every kernel from the checkout's sources, in parallel, and
    prints each instantiation's registers, shared memory and spills."""
    t0 = time.perf_counter()
    built = K.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for name, (lib_path, log) in built.items():
        print(f"  {name} -> {os.path.relpath(lib_path, _ROOT)}")
        for line in ptxas_summary(log):
            print("    ptxas:", line)


def device_kernels(fn) -> list[str]:
    """The names of the device kernels one call of ``fn`` launches
    (traced with ``torch.profiler``; copies and fills left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(3):  # a trace that caught no device event is retaken
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # one-cycle profiler
            with profile(activities=activities) as prof:
                fn()
                torch.cuda.synchronize()
        names = []
        for e in prof.key_averages():
            if (
                e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation
                and not e.key.startswith(("Memcpy", "Memset"))
            ):
                names += [e.key] * e.count
        if names:
            break
    return names


def launches_per_call(K, name: str, fn) -> tuple[int, list[str]]:
    """The device kernel launches of one call of ``fn``: the number the
    library of kernel ``name`` counts in its C entries, and their names as
    ``torch.profiler`` traced them in another call. The trace comes back
    empty now and then (on an H100 it caught no event on some calls late
    in a process, in three traces running), so the count is the check and
    a trace that caught anything must agree with it."""
    import torch

    torch.cuda.synchronize()
    before = K.device_launches(name)
    fn()
    torch.cuda.synchronize()
    counted = K.device_launches(name) - before
    return counted, device_kernels(fn)


def _check_one_launch(counted: int, traced: list[str], kernel: str) -> None:
    """Fails unless one solve was one device launch of ``kernel``."""
    if not traced:
        print(f"torch.profiler caught no device event of the {kernel} call")
    _check(counted == 1, f"one device launch per solve: {counted} counted")
    _check(
        not traced or (len(traced) == 1 and kernel in traced[0]),
        f"one device launch per solve: traced {traced}",
    )


def _random_inputs_phase(K, device) -> None:
    """Each kernel against its plain version on random inputs."""
    import torch

    for n in (10, 13, 16, 17):
        args, kw = random_kernel_inputs(n, seed=n, device=device)
        got = K.ip_sesolve(*args, **kw)
        torch.cuda.synchronize()
        want = K.ip_sesolve_reference(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"ip_sesolve vs plain, n={n}: max|d| = {err:.3e}")
        _check(bool(torch.isfinite(got).all()), f"finite output, n={n}")
        _check(err <= KERNEL_TOL, f"n={n}: {err:.3e} > {KERNEL_TOL}")
    # Batched K1: one block per trajectory (1, 4 and 8 amplitudes per
    # thread), then one cluster per trajectory (2 to 16 blocks); every
    # trajectory with its own drives, phase integrals and diagonal. Then
    # n = 14 to 17 with 100 trajectories, or more than two waves of the
    # clusters the card runs at once, 2 segments of 4 steps
    cases = [(n, 3, 8) for n in (10, 12, 13, 14, 17)]
    for n in range(14, 18):
        print(f"ip_sesolve batched, n={n}: {_batched_shape_line(K, n)}")
        waves = 2 * K.ip_sesolve_batched_config(n)["active"] + 1
        cases.append((n, max(100, waves), 4))
    for n, n_traj, seg_len in cases:
        args, kw = random_batched_kernel_inputs(
            n, seed=200 + n, device=device, n_traj=n_traj, seg_len=seg_len
        )
        lib = K.ip_sesolve_batched_library(n)
        before = K.device_launches(lib)
        got = K.ip_sesolve(*args, **kw)
        torch.cuda.synchronize()
        counted = K.device_launches(lib) - before
        want = K.ip_sesolve_reference(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(
            f"ip_sesolve batched vs plain, n={n}, {n_traj} trajectories:"
            f" max|d| = {err:.3e}, {counted} device launch(es) per batch"
        )
        _check(bool(torch.isfinite(got).all()), f"finite batched output, n={n}")
        _check(err <= BATCHED_TOL, f"batched n={n}: {err:.3e} > {BATCHED_TOL}")
        _check(counted == 1, f"batched n={n}: {counted} device launches")
        del got, want
    # K2: sub-warp states (n = 1, 2, 4), one amplitude per thread (7, 10),
    # then 2, 4 and 8 (11, 12, 13); carried rotors in segment 0,
    # recomputed ones in segment 1. Last, thresholds of 1: every
    # trajectory jumps after every step
    k2_cases = [(n, n, 0.9) for n in (1, 2, 4, 7, 10, 11, 12, 13)]
    k2_cases += [(n, 100 + n, 1.0) for n in (3, 10, 12)]
    for n, seed, threshold in k2_cases:
        args = random_mcwf_inputs(
            n, seed=seed, device=device, threshold=threshold
        )
        got, jumps = K.mcwf_rows(*args, cops=RANDOM_COPS)
        torch.cuda.synchronize()
        carried = int(K.MCWF_ROWS_CARRIED.sum())
        want, jumps_p = K.mcwf_rows_reference(*args, cops=RANDOM_COPS)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rows_agree, n_real = K.mcwf_rows_carried_steps(*args[2:5])
        print(
            f"mcwf_rows vs plain, n={n}, thresholds >= {threshold}:"
            f" max|d| = {err:.3e}, jumps {jumps.tolist()}, rotors carried"
            f" on {carried} of {len(jumps) * n_real} steps"
        )
        _check(bool(torch.isfinite(got).all()), f"finite K2 output, n={n}")
        _check(torch.equal(jumps, jumps_p), f"K2 jump counts, n={n}")
        _check(err <= MCWF_TOL, f"K2 n={n}: {err:.3e} > {MCWF_TOL}")
        _check(
            carried == int(rows_agree.sum()) > 0,
            f"K2 n={n}: carried {carried}, rows agree on {rows_agree}",
        )
        if threshold == 1.0:
            _check(
                int(jumps.min()) == n_real, f"K2 n={n}: a jump on every step"
            )
    for n in (4, 7, 10, 13):
        args, kw = random_k3_inputs(n, seed=n, device=device)
        got, jumps = K.mcwf(*args, **kw)
        torch.cuda.synchronize()
        want, jumps_p = K.mcwf_reference(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(
            f"mcwf vs plain, n={n}: max|d| = {err:.3e},"
            f" jumps {jumps.tolist()}"
        )
        _check(bool(torch.isfinite(got).all()), f"finite K3 output, n={n}")
        _check(torch.equal(jumps, jumps_p), f"K3 jump counts, n={n}")
        _check(err <= MCWF_TOL, f"K3 n={n}: {err:.3e} > {MCWF_TOL}")


def _barrier_us(K, blocks: int, threads: int, stages: int) -> float:
    """Microseconds of one grid barrier on K1's grid: a cooperative launch
    of ``stages`` barriers and no work, timed with CUDA events, median
    of 3 after one warm-up."""
    import torch

    probe = K._load("ip_sesolve").ip_sesolve_barrier_probe
    stream = torch.cuda.current_stream().cuda_stream
    times = []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = probe(blocks, threads, stages, stream)
        end.record()
        torch.cuda.synchronize()
        _check(err == 0, f"barrier probe: CUDA error {err}")
        times.append(start.elapsed_time(end) * 1e3 / stages)
    return statistics.median(times[1:])


def _k1_on_run(K, S, emu, device, what: str) -> tuple:
    """K1 against its plain version on the inputs of ``emu``'s last
    16-atom run (its plan, initial state and interaction diagonal):
    ``(args, kw, K1's states, max |Δ|)``; fails beyond SWEEP_TOL."""
    import torch

    psi0 = emu._initial_ket().astype(np.complex64)
    args, kw = S.ip_kernel_inputs(
        psi0, emu._plan_cache[1], emu._current_hamiltonian.int_diag, 16,
        device,
    )
    got = K.ip_sesolve(*args, **kw)
    want = K.ip_sesolve_reference(*args, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"ip_sesolve vs plain on {what}: max|d| = {err:.3e}")
    _check(err <= SWEEP_TOL, f"{what} K1: {err:.3e} > {SWEEP_TOL}")
    return args, kw, got, err


def _afm16_path(K, S, device, card: str) -> dict:
    """The noiseless main path at full size, counted, then K1 against its
    plain version on the sweep's own inputs, and the times."""
    import torch

    from pulser_tpu_torch.emulator import TorchEmulator

    _sequence_ms("AFM16", afm16_sequence, card)
    seq = afm16_sequence()
    eval_times = np.linspace(0, seq.get_duration() * 1e-3, 101)
    golden = np.load(_GOLDEN)
    _reset_launches(K)
    t0 = time.perf_counter()
    emu = TorchEmulator.from_sequence(seq, evaluation_times=eval_times)
    res = emu.run()
    mid = res.states[50].full()[:, 0]
    fin = res.states[-1].full()[:, 0]
    cold_s = time.perf_counter() - t0
    launches = _launches(K)["ip_sesolve"]
    info = dict(S.last_solve_info)
    print(f"main path: {info}, launches={launches}, cold {cold_s:.3f} s")
    _check(info.get("kind") == "ip_sesolve_cuda", "kernel route taken")
    _check(launches > 0, "ip_sesolve launched on the main path")
    for name, state in (("mid", mid), ("final", fin)):
        _check(state.shape == (1 << 16,), f"{name} state shape")
        _check(bool(np.isfinite(state).all()), f"{name} state finite")
    one_minus_f = {
        "mid": 1 - _fidelity(golden["mid_state"], mid),
        "final": 1 - _fidelity(golden["final_state"], fin),
    }
    print(f"1-F vs golden: {one_minus_f}")
    for name, value in one_minus_f.items():
        _check(value < FIDELITY_TOL, f"{name} 1-F {value:.3e}")

    plan = emu._plan_cache[1]
    args, kw, got, sweep_err = _k1_on_run(K, S, emu, device, "AFM16")
    kernel_s = _median_seconds(lambda: K.ip_sesolve(*args, **kw))
    plain_s = _median_seconds(lambda: K.ip_sesolve_reference(*args, **kw))
    run_s = _median_seconds(lambda: emu.run().states[-1].full())
    n, dim = 16, 1 << 16
    counted, launched = launches_per_call(
        K, "ip_sesolve", lambda: K.ip_sesolve(*args, **kw)
    )
    blocks, threads, amps = K.ip_sesolve_grid(n)
    stages = info["n_steps"] * 4
    print(
        f"ip_sesolve per call: {counted} device kernel launch(es) counted,"
        f" traced {sorted(set(launched))}; grid {blocks} x {threads} threads,"
        f" {amps} amplitude(s) per thread; {kernel_s * 1e6 / stages:.3f} us"
        f" per RK4 stage ({stages} stages, {card})"
    )
    _check_one_launch(counted, launched, "ip_sesolve_kernel")
    barrier_us = _barrier_us(K, blocks, threads, stages)
    print(
        f"ip_sesolve grid barrier alone on that grid: {barrier_us:.3f} us;"
        f" the rest of a stage (rotors, gathers, arithmetic):"
        f" {kernel_s * 1e6 / stages - barrier_us:.3f} us"
    )
    bound_ms, bound_by = _bound(
        info["n_steps"] * 4 * dim * _ops_per_amp_stage("ip_sesolve", n),
        _nbytes(*args, got),
    )
    print(
        f"times on {card}: ip_sesolve {kernel_s * 1e3:.3f} ms,"
        f" plain {plain_s * 1e3:.3f} ms, warm run() {run_s * 1e3:.3f} ms"
        f" ({info['n_steps']} RK4 steps, {plan.seg_dts.shape[0]} segments);"
        f" bound {bound_ms:.3f} ms ({bound_by})"
    )
    return {
        "name": "ip_sesolve",
        "path": "AFM16",
        "route": "cuda",
        "source": "pulser_tpu_torch/csrc/ip_sesolve.cu",
        "replaces": "pulser_tpu/ops/pallas_kernels.py:112",
        "launches": launches,
        "max_abs_err": sweep_err,
        "ms": kernel_s * 1e3,
        "plain_ms": plain_s * 1e3,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def _tri16_path(K, S, device, card: str) -> dict:
    """TRI16 at full size: the sequence designed on ``MockDevice`` and
    moved with ``with_new_device(AnalogDevice)`` runs on K1 in one launch;
    its samples equal the direct build's bit for bit, its final state
    equals that build's and the JAX package's golden; then K1 against its
    plain version on TRI16's own inputs, and the times."""
    import torch

    from pulser_tpu_torch.emulator import TorchEmulator

    _sequence_ms("TRI16", tri16_sequence, card)
    seq, direct = tri16_sequence(), tri16_direct_sequence()
    _check(seq.device.name == "AnalogDevice", "switched onto AnalogDevice")
    _check(
        seq.device.register_is_from_calibrated_layout(seq.register),
        "TRI16's register is on AnalogDevice's calibrated layout",
    )
    _check(str(seq) == str(direct), "str(switched) == str(direct build)")
    _check_samples_equal(seq, direct, "TRI16")
    eval_times = np.linspace(0, seq.get_duration() * 1e-3, 101)
    golden = np.load(_TRI16_GOLDEN)
    _reset_launches(K)
    c_before = K.device_launches("ip_sesolve")
    t0 = time.perf_counter()
    emu = TorchEmulator.from_sequence(seq, evaluation_times=eval_times)
    res = emu.run()
    mid = res.states[50].full()[:, 0]
    fin = res.states[-1].full()[:, 0]
    cold_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = _launches(K)
    c_launches = K.device_launches("ip_sesolve") - c_before
    info = dict(S.last_solve_info)
    print(
        f"TRI16: {info}, launches={launches}, C library count"
        f" {c_launches}, cold {cold_s:.3f} s"
    )
    _check(info.get("kind") == "ip_sesolve_cuda", "TRI16 takes K1")
    _check(launches["ip_sesolve"] == 1, "one K1 launch on TRI16")
    _check(c_launches == 1, "one K1 device launch by the library's count")
    _check(
        sum(launches.values()) == 1, f"no other kernel on TRI16: {launches}"
    )
    for name, state in (("mid", mid), ("final", fin)):
        _check(state.shape == (1 << 16,), f"TRI16 {name} state shape")
        _check(bool(np.isfinite(state).all()), f"TRI16 {name} finite")
    direct_fin = (
        TorchEmulator.from_sequence(direct, evaluation_times=eval_times)
        .run()
        .states[-1]
        .full()[:, 0]
    )
    vs_direct = 1 - _fidelity(direct_fin, fin)
    one_minus_f = {
        "mid": 1 - _fidelity(golden["mid_state"], mid),
        "final": 1 - _fidelity(golden["final_state"], fin),
    }
    print(
        f"TRI16 1-F vs the direct build: {vs_direct:.3e}; vs the JAX"
        f" package's golden: {one_minus_f}"
    )
    _check(
        vs_direct <= SWITCH_FIDELITY_TOL,
        f"TRI16 vs direct build 1-F {vs_direct:.3e}",
    )
    for name, value in one_minus_f.items():
        _check(value <= FIDELITY_TOL, f"TRI16 {name} 1-F {value:.3e}")

    plan = emu._plan_cache[1]
    args, kw, got, err = _k1_on_run(K, S, emu, device, "TRI16")
    kernel_s = _median_seconds(lambda: K.ip_sesolve(*args, **kw))
    plain_s = _median_seconds(lambda: K.ip_sesolve_reference(*args, **kw))
    run_s = _median_seconds(lambda: emu.run().states[-1].full())
    n, dim = 16, 1 << 16
    stages = info["n_steps"] * 4
    bound_ms, bound_by = _bound(
        stages * dim * _ops_per_amp_stage("ip_sesolve", n),
        _nbytes(*args, got),
    )
    print(
        f"times on {card}: TRI16 ip_sesolve {kernel_s * 1e3:.3f} ms"
        f" ({kernel_s * 1e6 / stages:.3f} us per RK4 stage), plain"
        f" {plain_s * 1e3:.3f} ms, warm run() {run_s * 1e3:.3f} ms"
        f" ({info['n_steps']} RK4 steps, {plan.seg_dts.shape[0]} segments);"
        f" bound {bound_ms:.3f} ms ({bound_by})"
    )
    return {
        "name": "ip_sesolve",
        "path": "TRI16",
        "route": "cuda",
        "source": "pulser_tpu_torch/csrc/ip_sesolve.cu",
        "replaces": "pulser_tpu/ops/pallas_kernels.py:112",
        "launches": launches["ip_sesolve"],
        "max_abs_err": err,
        "ms": kernel_s * 1e3,
        "plain_ms": plain_s * 1e3,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def _traced_head(S, solver_fn: str, captured: dict) -> tuple:
    """One traced call of ``S.<solver_fn>`` with the recorded arguments on
    the first :data:`_TRACE_STEPS` steps of the plan (argument 1):
    ``(wall seconds, busy ms, kernel launches, traced RK4 stages)``."""
    a, k = captured["args"], captured["kwargs"]
    head = _head_plan(a[1], _TRACE_STEPS)
    kw = dict(k, lazy=False) if "lazy" in k else k
    fn = getattr(S, solver_fn)
    wall_s, busy_ms, launches = _device_busy(lambda: fn(a[0], head, *a[2:], **kw))
    return wall_s, busy_ms, launches, 4 * int(np.count_nonzero(head.seg_dts))


def _recording(S, solver_fn: str, captured: dict):
    """A stand-in for ``S.<solver_fn>`` that records its arguments and
    output into ``captured``."""
    solve = getattr(S, solver_fn)

    def record(*a, **k):
        captured["args"], captured["kwargs"] = a, k
        captured["out"] = solve(*a, **k)
        return captured["out"]

    return solve, record


def _run_noisy(K, seq_and_noise, seed: int, solver_fn: str, S) -> tuple:
    """One seeded noisy ``run()`` through ``TorchEmulator.from_sequence``,
    counted, with the call of ``S.<solver_fn>`` recorded: ``(emulator,
    results, launches, cold seconds, {"args", "kwargs", "out"})``."""
    from pulser_tpu_torch.emulator import TorchEmulator

    seq, noise = seq_and_noise
    captured: dict = {}
    solve, record = _recording(S, solver_fn, captured)
    setattr(S, solver_fn, record)
    try:
        np.random.seed(seed)
        _reset_launches(K)
        t0 = time.perf_counter()
        emu = TorchEmulator.from_sequence(
            seq, noise_model=noise, evaluation_times="Minimal"
        )
        res = emu.run()
        cold_s = time.perf_counter() - t0
        launches = _launches(K)
    finally:
        setattr(S, solver_fn, solve)
    return emu, res, launches, cold_s, captured


def _check_shots(res) -> None:
    from pulser_tpu_torch.emulator import NoisyResults

    _check(isinstance(res, NoisyResults), "NoisyResults returned")
    shots = [sum(r.bitstring_counts.values()) for r in res]
    _check(all(c == 1000 for c in shots), f"1000 shots per time: {shots}")


def _odd_trajectories(per_traj, jumps, jumps_p, tol: float) -> list:
    """Trajectories whose jump record or states differ beyond ``tol``."""
    import torch

    return sorted(
        set(torch.nonzero(jumps != jumps_p).flatten().tolist())
        | set(torch.nonzero(per_traj > tol).flatten().tolist())
    )


def _k2_on_run(K, S, captured, device, what: str) -> tuple:
    """K2 against its plain version on the inputs of a recorded
    ``mcsolve_rows_codes`` call, trajectory by trajectory: ``(inputs,
    collapse spec, K2's states, jump counts, max |Δ|)``. Fails unless all
    but at most one trajectory (whose jump record may differ) are within
    MCWF_TOL."""
    import torch

    psi0_n, plans, diags, _, _, _, cops, seeds, _ = captured["args"]
    cops_spec = S._diag_cops_spec(cops)
    margs = S.rows_kernel_inputs(psi0_n, plans, diags, seeds, device)
    got, jumps = K.mcwf_rows(*margs, cops=cops_spec)
    want, jumps_p = K.mcwf_rows_reference(*margs, cops=cops_spec)
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(got).all()), f"finite K2 states on {what}")
    per_traj = (got - want).abs().amax(dim=(1, 2, 3))
    odd = _odd_trajectories(per_traj, jumps, jumps_p, MCWF_TOL)
    keep = torch.ones_like(per_traj, dtype=torch.bool)
    keep[odd] = False
    err = float(per_traj[keep].max())
    print(
        f"mcwf_rows vs plain on {what}: max|d| = {err:.3e}"
        f" over {int(keep.sum())} trajectories; jump record differs for"
        f" {odd}; jumps per trajectory: mean"
        f" {float(jumps.float().mean()):.2f}, max {int(jumps.max())}"
    )
    _check(len(odd) <= 1, f"K2 vs plain differ on trajectories {odd}")
    _check(err <= MCWF_TOL, f"K2 {what}: {err:.3e} > {MCWF_TOL}")
    return margs, cops_spec, got, jumps, err


def _noisy10_path(K, S, device, card: str) -> dict:
    """The noisy main path at full size (K2), against the JAX package's
    figures, then K2 against its plain version on the run's own inputs,
    the times and the device's busy share."""
    import torch

    _sequence_ms("NOISY10", lambda: noisy10_sequence()[0], card)
    noisy, nres, launches, cold_s, captured = _run_noisy(
        K, noisy10_sequence(), NOISY10_REFERENCE["seed"], "mcsolve_rows_codes",
        S,
    )
    mcwf_launches = launches["mcwf_rows"]
    ninfo = dict(S.last_solve_info)
    print(
        f"noisy path: {ninfo}, launches={mcwf_launches},"
        f" cold {cold_s:.3f} s"
    )
    _check(ninfo.get("kind") == "mcwf_rows_cuda", "K2 route taken")
    _check(mcwf_launches > 0, "mcwf_rows launched on the noisy path")
    _check_shots(nres)
    final_counts = dict(nres[-1].bitstring_counts)
    tv = _tv_distance(final_counts, NOISY10_REFERENCE["final_counts"])

    psi0_n, plans, diags, _, _, n_q, _, seeds, sample_spec = captured[
        "args"
    ]
    margs, cops_spec, got, jumps, mcwf_err = _k2_on_run(
        K, S, captured, device, "NOISY10"
    )
    pops = _rydberg_populations(_plane_probs(got[:, -1]), n_q).mean(axis=0)
    pop_err = float(
        np.max(np.abs(pops - NOISY10_REFERENCE["rydberg_populations"]))
    )
    print(
        f"vs the JAX package (seed {NOISY10_REFERENCE['seed']}):"
        f" Rydberg populations max|d| = {pop_err:.3e},"
        f" final counts TV = {tv:.4f}"
    )
    _check(pop_err <= POPULATION_TOL, f"populations {pop_err:.3e}")
    _check(tv <= COUNTS_TV_TOL, f"count TV {tv:.4f}")

    mcwf_s = _median_seconds(lambda: K.mcwf_rows(*margs, cops=cops_spec))
    counted, launched = launches_per_call(
        K, "mcwf_rows", lambda: K.mcwf_rows(*margs, cops=cops_spec)
    )
    stages = ninfo["n_steps"] * 4
    rows_agree, n_real = K.mcwf_rows_carried_steps(*margs[2:5])
    carried = int(K.MCWF_ROWS_CARRIED.sum())
    print(
        f"mcwf_rows per call: {counted} device kernel launch(es) counted,"
        f" traced {sorted(set(launched))}; {mcwf_s * 1e6 / stages:.3f} us per"
        f" RK4 stage ({stages} stages per trajectory, all trajectories at"
        f" once; {card}); end-of-step rotor carried into {carried} of"
        f" {plans.n_traj * (n_real - 1)} following steps"
        f" ({100 * carried / (plans.n_traj * (n_real - 1)):.2f}%)"
    )
    _check_one_launch(counted, launched, "mcwf_rows_kernel")
    _check(n_real == ninfo["n_steps"], f"{n_real} non-padding steps")
    _check(
        carried == int(rows_agree.sum()),
        f"carried {carried}, rows agree on {int(rows_agree.sum())}",
    )
    t0 = time.perf_counter()
    K.mcwf_rows_reference(*margs, cops=cops_spec)
    torch.cuda.synchronize()
    mcwf_plain_s = time.perf_counter() - t0
    noisy_run_s = _median_seconds(noisy.run)
    opts: dict = {}
    noisy._validate_options(opts)  # the options run() solves with
    prep_s = _median_seconds(lambda: noisy._lindblad_batch_prep(dict(opts)))
    stage_s = _median_seconds(
        lambda: S.rows_kernel_inputs(psi0_n, plans, diags, seeds, device)
    )
    epilogue_s = _median_seconds(
        lambda: S._sample_codes(got, sample_spec, plans.plan.eval_map).cpu()
    )
    n_traj, dim = plans.n_traj, 1 << n_q
    bound_ms, bound_by = _bound(
        n_traj * ninfo["n_steps"] * 4 * dim
        * _ops_per_amp_stage("mcwf_rows", n_q)
        + int(jumps.sum()) * dim * (2 * n_q + 9),
        _nbytes(*margs, got, jumps),
    )
    print(
        f"times on {card}: mcwf_rows {mcwf_s * 1e3:.3f} ms,"
        f" plain (once) {mcwf_plain_s * 1e3:.3f} ms, warm noisy run()"
        f" {noisy_run_s * 1e3:.3f} ms, of which host prep (trajectory"
        f" draws, batch, plan) {prep_s * 1e3:.3f} ms, staging and uniforms"
        f" {stage_s * 1e3:.3f} ms and the sampling epilogue with its fetch"
        f" {epilogue_s * 1e3:.3f} ms ({ninfo['n_steps']} RK4 steps,"
        f" {ninfo['n_traj']} trajectories); bound {bound_ms:.3f} ms"
        f" ({bound_by})"
    )
    _print_busy("noisy run()", *_device_busy(noisy.run)[:2])
    return {
        "name": "mcwf_rows",
        "path": "NOISY10",
        "route": "cuda",
        "source": "pulser_tpu_torch/csrc/mcwf_rows.cu",
        "replaces": "pulser_tpu/ops/pallas_kernels.py:824",
        "launches": mcwf_launches,
        "max_abs_err": mcwf_err,
        "ms": mcwf_s * 1e3,
        "plain_ms": mcwf_plain_s * 1e3,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def _regnoise10_path(K, S, device, card: str) -> dict:
    """REGNOISE10 at full size: NOISY10 with register noise, 100
    trajectories with 100 distinct interaction diagonals, on K2 in one
    launch, against the JAX package's figures for the same seed; then K2
    against its plain version on the run's own inputs, the times and the
    device's busy share."""
    import torch

    with open(_REGNOISE10_GOLDEN) as f:
        ref = json.load(f)
    _sequence_ms("REGNOISE10", lambda: regnoise10_sequence()[0], card)
    seq_noise = regnoise10_sequence()
    _check(
        sorted(seq_noise[1].noise_types) == ref["noise_types"],
        f"REGNOISE10 noise types {sorted(seq_noise[1].noise_types)}",
    )
    c_before = K.device_launches("mcwf_rows")
    emu, res, launches, cold_s, captured = _run_noisy(
        K, seq_noise, ref["seed"], "mcsolve_rows_codes", S
    )
    c_launches = K.device_launches("mcwf_rows") - c_before
    info = dict(S.last_solve_info)
    print(
        f"REGNOISE10: {info}, launches={launches}, C library count"
        f" {c_launches}, cold {cold_s:.3f} s"
    )
    _check(info.get("kind") == "mcwf_rows_cuda", "REGNOISE10 takes K2")
    _check(launches["mcwf_rows"] == 1, "one K2 launch on REGNOISE10")
    _check(c_launches == 1, "one K2 device launch by the library's count")
    _check(
        sum(launches.values()) == 1,
        f"no other kernel on REGNOISE10: {launches}",
    )
    _check(info["n_steps"] == ref["n_steps"], "the JAX package's grid")
    _check_shots(res)

    psi0_n, plans, diags, _, _, n_q, _, seeds, _ = captured["args"]
    margs, cops_spec, got, jumps, err = _k2_on_run(
        K, S, captured, device, "REGNOISE10"
    )
    distinct = int(torch.unique(margs[9], dim=0).shape[0])
    print(
        f"REGNOISE10: {distinct} distinct interaction diagonals among the"
        f" {margs[9].shape[0]} handed to K2 (the JAX package's batch:"
        f" {ref['distinct_diagonals']})"
    )
    _check(
        distinct == ref["distinct_diagonals"] == plans.n_traj,
        f"one diagonal per trajectory: {distinct}",
    )
    pops = _rydberg_populations(_plane_probs(got[:, -1]), n_q).mean(axis=0)
    pop_err = float(np.max(np.abs(pops - ref["rydberg_populations"])))
    tv = _tv_distance(dict(res[-1].bitstring_counts), ref["final_counts"])
    print(
        f"REGNOISE10 vs the JAX package (seed {ref['seed']}): Rydberg"
        f" populations max|d| = {pop_err:.3e}, final counts TV = {tv:.4f}"
    )
    _check(
        pop_err <= POPULATION_TOL, f"REGNOISE10 populations {pop_err:.3e}"
    )
    _check(tv <= COUNTS_TV_TOL, f"REGNOISE10 count TV {tv:.4f}")

    mcwf_s = _median_seconds(lambda: K.mcwf_rows(*margs, cops=cops_spec))
    t0 = time.perf_counter()
    K.mcwf_rows_reference(*margs, cops=cops_spec)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    run_s = _median_seconds(emu.run)
    opts: dict = {}
    emu._validate_options(opts)  # the options run() solves with
    prep_s = _median_seconds(lambda: emu._lindblad_batch_prep(dict(opts)))
    stage_s = _median_seconds(
        lambda: S.rows_kernel_inputs(psi0_n, plans, diags, seeds, device)
    )
    n_traj, dim = plans.n_traj, 1 << n_q
    bound_ms, bound_by = _bound(
        n_traj * info["n_steps"] * 4 * dim
        * _ops_per_amp_stage("mcwf_rows", n_q)
        + int(jumps.sum()) * dim * (2 * n_q + 9),
        _nbytes(*margs, got, jumps),
    )
    print(
        f"times on {card}: REGNOISE10 mcwf_rows {mcwf_s * 1e3:.3f} ms,"
        f" plain (once) {plain_s * 1e3:.3f} ms, warm run()"
        f" {run_s * 1e3:.3f} ms, of which host prep {prep_s * 1e3:.3f} ms"
        f" and staging {stage_s * 1e3:.3f} ms ({info['n_steps']} RK4"
        f" steps, {info['n_traj']} trajectories); bound {bound_ms:.3f} ms"
        f" ({bound_by})"
    )
    _print_busy("REGNOISE10 run()", *_device_busy(emu.run)[:2])
    return {
        "name": "mcwf_rows",
        "path": "REGNOISE10",
        "route": "cuda",
        "source": "pulser_tpu_torch/csrc/mcwf_rows.cu",
        "replaces": "pulser_tpu/ops/pallas_kernels.py:824",
        "launches": launches["mcwf_rows"],
        "max_abs_err": err,
        "ms": mcwf_s * 1e3,
        "plain_ms": plain_s * 1e3,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def _pauli10_path(K, S, device, card: str) -> dict:
    """The lab-frame quantum-jump main path at full size (K3): PAULI10
    against the JAX package's figures, then K3 against its plain version
    on the run's own inputs, the times and the device's busy share."""
    import torch

    from pulser_tpu_torch.emulator.simulation import _host_sample_codes

    with open(_PAULI10_GOLDEN) as f:
        ref = json.load(f)
    _sequence_ms("PAULI10", lambda: pauli10_sequence()[0], card)
    pauli, pres, launches, cold_s, captured = _run_noisy(
        K, pauli10_sequence(), ref["seed"], "mcsolve_rk4_batched", S
    )
    k3_launches = launches["mcwf"]
    pinfo = dict(S.last_solve_info)
    print(
        f"PAULI10 path: {pinfo}, launches={launches}, cold {cold_s:.3f} s"
    )
    _check(pinfo.get("kind") == "mcwf_cuda", "K3 route taken")
    _check(k3_launches > 0, "mcwf launched on the PAULI10 path")
    _check(pinfo["n_steps"] == ref["n_steps"], f"steps {pinfo['n_steps']}")
    _check_shots(pres)
    tv = _tv_distance(
        dict(pres[-1].bitstring_counts), ref["final_counts"]
    )
    states = captured["out"]  # (B, n_eval, dim) complex64
    _check(bool(np.isfinite(states).all()), "finite PAULI10 states")
    n_q = pinfo["n"]
    pops = _rydberg_populations(
        np.abs(states[:, -1].astype(np.complex128)) ** 2, n_q
    )
    pop_d = np.max(np.abs(pops - np.asarray(ref["rydberg_populations"])), 1)
    far = np.flatnonzero(pop_d > POPULATION_TOL).tolist()
    pop_err = float(np.delete(pop_d, far).max())
    print(
        f"vs the JAX package (seed {ref['seed']}): per-trajectory Rydberg"
        f" populations max|d| = {pop_err:.3e} beyond {far} (those"
        f" {[float(pop_d[t]) for t in far]}), final counts TV = {tv:.4f}"
    )
    _check(len(far) <= 1, f"populations differ on trajectories {far}")
    _check(tv <= COUNTS_TV_TOL, f"count TV {tv:.4f}")

    psi0_p, plans, diags, _, _, _, cops, seeds = captured["args"]
    margs, mkw = S.mcwf_kernel_inputs(
        psi0_p, plans, diags, cops, seeds, device
    )
    got, jumps = K.mcwf(*margs, **mkw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, jumps_p = K.mcwf_reference(*margs, **mkw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _check(bool(torch.isfinite(got).all()), "finite K3 states")
    per_traj = (got - want).abs().amax(dim=(1, 2, 3))
    odd = _odd_trajectories(per_traj, jumps, jumps_p, MCWF_TOL)
    keep = torch.ones_like(per_traj, dtype=torch.bool)
    keep[odd] = False
    k3_err = float(per_traj[keep].max())
    print(
        f"mcwf vs plain on the PAULI10 run: max|d| = {k3_err:.3e} over"
        f" {int(keep.sum())} trajectories; jump record differs for {odd};"
        f" jumps per trajectory: mean {float(jumps.float().mean()):.2f},"
        f" max {int(jumps.max())}"
    )
    _check(len(odd) <= 1, f"K3 vs plain differ on trajectories {odd}")
    _check(k3_err <= MCWF_TOL, f"K3 PAULI10: {k3_err:.3e} > {MCWF_TOL}")

    k3_s = _median_seconds(lambda: K.mcwf(*margs, **mkw))
    counted, launched = launches_per_call(
        K, "mcwf", lambda: K.mcwf(*margs, **mkw)
    )
    stages = pinfo["n_steps"] * 4
    print(
        f"mcwf per call: {counted} device kernel launch(es) counted, traced"
        f" {sorted(set(launched))}; {k3_s * 1e6 / stages:.3f} us per RK4"
        f" stage ({stages} stages per trajectory, all trajectories at once;"
        f" {card})"
    )
    _check_one_launch(counted, launched, "mcwf_kernel")
    run_s = _median_seconds(pauli.run)
    opts: dict = {}
    pauli._validate_options(opts)  # the options run() solves with
    prep_s = _median_seconds(lambda: pauli._lindblad_batch_prep(dict(opts)))
    stage_s = _median_seconds(
        lambda: S.mcwf_kernel_inputs(psi0_p, plans, diags, cops, seeds, device)
    )
    # The draws of one run: samples_per_run per (trajectory, time) entry
    # (PAULI10's continuous noise draws repeat no trajectory)
    ns = np.full(
        states.shape[0] * states.shape[1], pauli.noise_model.samples_per_run
    )
    rnd = np.random.default_rng(0).random(int(ns.sum()))
    t0 = time.perf_counter()
    _host_sample_codes(states, ns, rnd)
    sampling_s = time.perf_counter() - t0
    n_traj, dim = plans.n_traj, 1 << n_q
    n_cops = len(mkw["cops"])
    bound_ms, bound_by = _bound(
        n_traj * pinfo["n_steps"] * 4 * dim * _ops_per_amp_stage("mcwf", n_q)
        + int(jumps.sum()) * dim * (20 * n_cops * n_q + 12),
        _nbytes(*margs, got, jumps),
    )
    print(
        f"times on {card}: mcwf {k3_s * 1e3:.3f} ms, plain (once)"
        f" {plain_s * 1e3:.3f} ms, warm PAULI10 run() {run_s * 1e3:.3f} ms,"
        f" of which host prep (trajectory draws, batch, plan)"
        f" {prep_s * 1e3:.3f} ms, staging and uniforms"
        f" {stage_s * 1e3:.3f} ms, host sampling {sampling_s * 1e3:.3f} ms"
        f" ({pinfo['n_steps']} RK4 steps, {n_traj} trajectories, {n_cops}"
        f" collapse operators); bound {bound_ms:.3f} ms ({bound_by})"
    )
    _print_busy("PAULI10 run()", *_device_busy(pauli.run)[:2])
    return {
        "name": "mcwf",
        "path": "PAULI10",
        "route": "cuda",
        "source": "pulser_tpu_torch/csrc/mcwf.cu",
        "replaces": "pulser_tpu/ops/pallas_kernels.py:412",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": k3_s * 1e3,
        "plain_ms": plain_s * 1e3,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def _timed_parts(emu, S, sim, solver_fn: str = "sesolve_rk4_batched") -> dict:
    """Wall seconds of the parts of one warm noisy ``run()``: host
    preparation (trajectory draws, batch, step policy, plan), the solve
    call ``S.<solver_fn>`` (staging, solve, fetch), the wrapping of the
    states into results (none on the pure-state route), and the
    sampling (on the host, or on the card from the batched kernel's
    output)."""
    marks: dict = {}
    solve = getattr(S, solver_fn)
    # The pure-state route draws from its states, the others from the
    # weight rows of their wrapped results
    samplers = {
        name: getattr(sim, name)
        for name in (
            "_sample_weight_rows", "_sample_ket_states",
            "_sample_batched_kets",
        )
    }

    def timed_solve(*a, **k):
        marks["solve_begin"] = time.perf_counter()
        out = solve(*a, **k)
        marks["solve_end"] = time.perf_counter()
        return out

    def timed(sample):
        def timed_sample(*a, **k):
            marks["sample_begin"] = time.perf_counter()
            out = sample(*a, **k)
            marks["sample_end"] = time.perf_counter()
            return out

        return timed_sample

    setattr(S, solver_fn, timed_solve)
    for name, sample in samplers.items():
        setattr(sim, name, timed(sample))
    try:
        start = time.perf_counter()
        emu.run()
        end = time.perf_counter()
    finally:
        setattr(S, solver_fn, solve)
        for name, sample in samplers.items():
            setattr(sim, name, sample)
    return {
        "prep": marks["solve_begin"] - start,
        "solve": marks["solve_end"] - marks["solve_begin"],
        "wrap": marks["sample_begin"] - marks["solve_end"],
        "sampling": marks["sample_end"] - marks["sample_begin"],
        "rest": end - marks["sample_end"],
    }


def _spd_path(K, S, device, card: str, name: str, build, golden: str) -> dict:
    """A noisy main path without collapse operators at full size (K1's
    trajectory-batched mode: SPD10, a block a trajectory, and SPD16, a
    thread-block cluster a trajectory): ``build()``'s ``(sequence,
    noise)`` against the JAX package's figures in ``golden``, then the
    kernel against its plain version on the run's own inputs, the times,
    the bound, the trajectories the card runs at once and the device's
    busy share."""
    import torch

    from pulser_tpu_torch.emulator import simulation as sim

    with open(golden) as f:
        ref = json.load(f)
    _sequence_ms(name, lambda: build()[0], card)
    spd, sres, launches, cold_s, captured = _run_noisy(
        K, build(), ref["seed"], "sesolve_rk4_batched", S
    )
    k1b_launches = launches["ip_sesolve_batched"]
    sinfo = dict(S.last_solve_info)
    n_q = sinfo["n"]
    lib = K.ip_sesolve_batched_library(n_q)
    print(f"{name} path: {sinfo}, launches={launches}, cold {cold_s:.3f} s")
    _check(sinfo.get("kind") == "ip_sesolve_batched_cuda", "batched K1 route")
    _check(k1b_launches > 0, f"batched ip_sesolve launched on the {name} path")
    _check(sinfo["n_steps"] == ref["n_steps"], f"steps {sinfo['n_steps']}")
    _check(sinfo["n_traj"] == ref["n_traj"], f"trajectories {sinfo['n_traj']}")
    _check_shots(sres)
    tv = _tv_distance(dict(sres[-1].bitstring_counts), ref["final_counts"])
    # The route leaves the batch on the card (S.BatchedKets) and draws the
    # shots there: fetched here for the checks
    _check(isinstance(captured["out"], S.BatchedKets), "the batch on the card")
    states = captured["out"].fetch()  # (B, n_eval, dim) complex64
    _check(bool(np.isfinite(states).all()), f"finite {name} states")
    probs = np.abs(states[:, -1].astype(np.complex128)) ** 2
    probs /= probs.sum(axis=1, keepdims=True)  # as run() renormalizes
    pops = _rydberg_populations(probs, n_q)
    pop_err = float(
        np.max(np.abs(pops.mean(0) - ref["rydberg_populations_mean"]))
    )
    traj_err = float(
        np.max(np.abs(pops - np.asarray(ref["rydberg_populations"])))
    )
    print(
        f"vs the JAX package (seed {ref['seed']}): trajectory-averaged"
        f" Rydberg populations max|d| = {pop_err:.3e} (per trajectory"
        f" {traj_err:.3e}), final counts TV = {tv:.4f}"
    )
    _check(pop_err <= POPULATION_TOL, f"populations {pop_err:.3e}")
    _check(traj_err <= POPULATION_TOL, f"per-trajectory {traj_err:.3e}")
    _check(tv <= COUNTS_TV_TOL, f"count TV {tv:.4f}")

    psi0_s, plans, diags = captured["args"][:3]
    n_traj, dim = plans.n_traj, 1 << n_q
    bargs, bkw = S.ip_batched_kernel_inputs(psi0_s, plans, diags, n_q, device)
    got = K.ip_sesolve(*bargs, **bkw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = K.ip_sesolve_reference(*bargs, **bkw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _check(bool(torch.isfinite(got).all()), "finite batched K1 states")
    g = got.reshape(n_traj, -1, 2, dim).double()
    w = want.reshape(n_traj, -1, 2, dim).double()
    del want
    per_traj = (g - w).abs().amax(dim=(1, 2, 3))
    k1b_err = float(per_traj.max())
    gf = torch.complex(g[:, -1, 0], g[:, -1, 1])
    wf = torch.complex(w[:, -1, 0], w[:, -1, 1])
    del g, w
    fid = (wf.conj() * gf).sum(1).abs() ** 2 / (
        gf.abs().pow(2).sum(1) * wf.abs().pow(2).sum(1)
    )
    infid = float((1 - fid).max())
    print(
        f"ip_sesolve batched vs plain on the {name} run: max|d| ="
        f" {k1b_err:.3e} over {n_traj} trajectories (worst trajectory"
        f" {int(per_traj.argmax())}), final states 1-F <= {infid:.3e}"
    )
    _check(k1b_err <= BATCHED_TOL, f"{name}: {k1b_err:.3e} > {BATCHED_TOL}")
    _check(infid <= FIDELITY_TOL, f"{name} 1-F {infid:.3e}")

    k1b_s = _median_seconds(lambda: K.ip_sesolve(*bargs, **bkw))
    counted, launched = launches_per_call(
        K, lib, lambda: K.ip_sesolve(*bargs, **bkw)
    )
    stages = sinfo["n_steps"] * 4
    shape = _batched_shape_line(K, n_q)
    print(
        f"ip_sesolve batched per call: {counted} device kernel launch(es)"
        f" counted, traced {sorted(set(launched))}; {shape};"
        f" {k1b_s * 1e6 / stages:.3f} us per RK4 stage of the batch"
        f" ({stages} stages per trajectory; {card})"
    )
    _check_one_launch(counted, launched, "ip_sesolve_batched_kernel")
    # Three warm runs, each split into its parts
    parts = [_timed_parts(spd, S, sim) for _ in range(3)]
    part = {k: statistics.median(p[k] for p in parts) for k in parts[0]}
    run_s = statistics.median(sum(p.values()) for p in parts)
    stage_s = _median_seconds(
        lambda: S.ip_batched_kernel_inputs(psi0_s, plans, diags, n_q, device)
    )
    fetch_s = _median_seconds(lambda: got.cpu().numpy())
    bound_ms, bound_by = _bound(
        n_traj * stages * dim * _ops_per_amp_stage("ip_sesolve_batched", n_q),
        _nbytes(*bargs, got),
    )
    print(
        f"times on {card}: ip_sesolve batched {k1b_s * 1e3:.3f} ms, plain"
        f" (once) {plain_s * 1e3:.3f} ms, warm {name} run()"
        f" {run_s * 1e3:.3f} ms, of which host prep (trajectory draws,"
        f" dense batch, plan staged on the host) {part['prep'] * 1e3:.3f}"
        f" ms, the solve call {part['solve'] * 1e3:.3f} ms (alone: staging"
        f" {stage_s * 1e3:.3f} ms, fetch {fetch_s * 1e3:.3f} ms), wrapping"
        f" the states into results {part['wrap'] * 1e3:.3f} ms, host"
        f" sampling (on the card) {part['sampling'] * 1e3:.3f} ms"
        f" ({sinfo['n_steps']} RK4 steps, {n_traj} trajectories); bound"
        f" {bound_ms:.3f} ms ({bound_by})"
    )
    _print_busy(f"{name} run()", *_device_busy(spd.run)[:2])
    return {
        "name": "ip_sesolve_batched",
        "path": name,
        "route": "cuda",
        "source": "pulser_tpu_torch/csrc/ip_sesolve_batched.cu",
        "replaces": "pulser_tpu/ops/pallas_kernels.py:112",
        "launches": k1b_launches,
        "max_abs_err": k1b_err,
        "ms": k1b_s * 1e3,
        "plain_ms": plain_s * 1e3,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def _sampler_path(K, S, device, card: str) -> dict:
    """The shot sampler on the batch of the benchmark's ``spd16.shots``
    cell: one seeded SPD16 ``run()`` at 101 evaluation times drawing its
    shots on the card (one launch, only the int32 indices fetched), then
    the kernel on that run's kets against its plain version, one for
    one, its time alone, the plain version's and the bound."""
    import torch

    from pulser_tpu_torch import profiling
    from pulser_tpu_torch.emulator import TorchEmulator
    from pulser_tpu_torch.emulator import simulation as sim

    seq, noise = spd16_sequence()
    times = np.linspace(0, seq.get_duration() * 1e-3, 101)
    calls: list = []
    draw = sim._sample_batched_kets

    def keep(kets, renormalize, time_index, reverse, ns, *rest):
        calls.append((kets, renormalize, time_index, reverse, ns))
        return draw(kets, renormalize, time_index, reverse, ns, *rest)

    sim._sample_batched_kets = keep
    try:
        for seed in (1234, 1235):  # the first builds and loads
            np.random.seed(seed)
            emu = TorchEmulator.from_sequence(
                seq, noise_model=noise, evaluation_times=times
            )
            before = K.device_launches("sample_states")
            profiling.counter_report(reset=True)
            t0 = time.perf_counter()
            emu.run()
            run_s = time.perf_counter() - t0
            report = profiling.counter_report(reset=True)
            counted = K.device_launches("sample_states") - before
    finally:
        sim._sample_batched_kets = draw
    kets, renormalize, time_index, reverse, ns = calls[-1]
    shots = int(sum(ns))
    _check(counted == 1, f"one sample_states launch a run, not {counted}")
    _check(
        report["traj.fetched_bytes"] == shots * 4,
        f"only the indices fetched: {report['traj.fetched_bytes']} B",
    )
    offs = np.concatenate(([0], np.cumsum(ns))).astype(np.int64)
    u = np.random.default_rng(7).random(shots)
    args = [
        kets.planes,
        torch.from_numpy(kets.eval_map[np.asarray(time_index)]).to(device),
        torch.from_numpy(offs).to(device),
        torch.from_numpy(u).to(device),
    ]
    kw = dict(renormalize=renormalize, reverse=reverse)
    got = K.sample_states(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = K.sample_states_reference(*args, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    differ = int((got != want).sum())
    k_s = _median_seconds(lambda: K.sample_states(*args, **kw))
    counted_call, launched = launches_per_call(
        K, "sample_states", lambda: K.sample_states(*args, **kw)
    )
    n_traj, _, _, dim = kets.planes.shape
    read = n_traj * len(time_index) * dim * 8
    bound_ms, bound_by = _bound(0.0, read + _nbytes(*args[1:], got))
    print(
        f"SPD16 shots on the card ({n_traj} trajectories x"
        f" {len(time_index)} times, {shots} shots, renormalize"
        f" {renormalize}, reverse {reverse}): run() {run_s * 1e3:.3f} ms,"
        f" one sample_states launch, {report['traj.fetched_bytes']} B"
        f" fetched, {sum(v for k, v in report.items() if k.startswith('sync.'))}"
        f" waiting reads; sample_states {k_s * 1e3:.3f} ms, plain (once)"
        f" {plain_s * 1e3:.3f} ms, {differ} of {shots} indices differ;"
        f" bound {bound_ms:.3f} ms ({bound_by}, {read / 1e9:.4f} GB of"
        f" states read once); {counted_call} device launch(es) a call,"
        f" traced {sorted(set(launched))} [{card}]"
    )
    _check(differ <= max(1, shots // 10000), f"{differ} indices differ")
    _check_one_launch(counted_call, launched, "sample_states_kernel")
    return {
        "name": "sample_states",
        "path": "SPD16 (spd16.shots' batch)",
        "route": "cuda",
        "source": "pulser_tpu_torch/csrc/sample_states.cu",
        "replaces": None,
        "launches": counted,
        "max_abs_err": differ,
        "ms": k_s * 1e3,
        "plain_ms": plain_s * 1e3,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def _batched_shape_line(K, n: int) -> str:
    """The trajectory-batched mode's shape for n qubits, as the C library
    reports it, checked against the wrapper's table: blocks and threads
    a trajectory and the trajectories the card runs at once."""
    got = K.ip_sesolve_batched_config(n)
    want = K.ip_sesolve_batched_shape(n)
    _check(
        {k: got[k] for k in want} == want,
        f"n={n}: the library's shape {got} is not the wrapper's {want}",
    )
    _check(got["active"] > 0, f"n={n}: no trajectory fits the card: {got}")
    return (
        f"{got['blocks']} block(s) of {got['threads']} threads a trajectory"
        f" ({got['smem_bytes']} B dynamic shared memory a block),"
        f" {got['active']} trajectories at once"
    )


def _rho_checks(rho: np.ndarray, ref: dict, what: str) -> None:
    """Trace, Hermiticity, populations, diagonal and the 64 sampled
    off-diagonal elements of a final ρ against the JAX package's."""
    n = ref["n"]
    rho = np.asarray(rho, dtype=np.complex128)
    diag = np.real(np.diag(rho))
    trace_err = abs(np.trace(rho) - 1.0)
    herm_err = float(np.abs(rho - rho.conj().T).max())
    pops = _rydberg_populations(diag[None], n)[0]
    pop_err = float(np.abs(pops - ref["rydberg_populations"]).max())
    diag_err = float(np.abs(diag - ref["diagonal"]).max())
    off = ref.get("offdiagonal") or []
    off_err = max(
        (abs(rho[int(r), int(c)] - complex(re, im)) for r, c, re, im in off),
        default=0.0,
    )
    print(
        f"{what} vs the JAX package: |tr-1| = {trace_err:.3e}, max|rho -"
        f" rho^H| = {herm_err:.3e}, Rydberg populations max|d| ="
        f" {pop_err:.3e}, diagonal max|d| = {diag_err:.3e}, sampled"
        f" off-diagonal max|d| = {off_err:.3e}"
    )
    _check(trace_err <= TRACE_TOL, f"{what} trace {trace_err:.3e}")
    _check(herm_err <= HERMITIAN_TOL, f"{what} Hermitian {herm_err:.3e}")
    _check(pop_err <= RHO_TOL, f"{what} populations {pop_err:.3e}")
    _check(max(diag_err, off_err) <= RHO_TOL, f"{what} rho {diag_err:.3e}")


def _path_entry(
    name, run_ms, stages, solve_ms, launches, state_bytes, busy_share
) -> dict:
    """A ``paths`` entry of the report: the warm ``run()`` time, the RK4
    stages, the solve's ms per stage, the device kernel launches per stage,
    the bytes of the state (ρ, or the batch of state vectors), the least
    time per stage the memory rate allows (read the state once and write
    its derivative once), and the device's busy share of a traced run."""
    return {
        "name": name,
        "ms": run_ms,
        "stages": stages,
        "ms_per_stage": solve_ms / stages,
        "ops_per_stage": launches / stages,
        "state_bytes": state_bytes,
        "floor_ms_per_stage": 2 * state_bytes / PEAK_BYTES_PER_S * 1e3,
        "busy_share": busy_share,
    }


def _head_plan(plan, steps: int):
    """The first ``steps`` steps of ``plan``'s last (longest) segment as a
    plan of its own, emitted at that segment's evaluation time: the same
    RK4 stages as the full solve, for a trace short enough to read."""
    import dataclasses

    return dataclasses.replace(
        plan,
        seg_map=plan.seg_map[-1:, :steps],
        seg_dts=plan.seg_dts[-1:, :steps],
        eval_times=plan.eval_times[-1:],
        eval_det_cum=(
            None if plan.eval_det_cum is None else plan.eval_det_cum[-1:]
        ),
        eval_map=np.zeros(1, dtype=np.int64),
        runtime_cache={},
    )


def _timed_call(fn, S, solver_fn: str) -> tuple[float, float]:
    """Wall seconds of ``fn()`` and of the ``S.<solver_fn>`` call inside
    it, each up to the device's completion."""
    import torch

    solve, marks = getattr(S, solver_fn), {}

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = solve(*a, **k)
        torch.cuda.synchronize()
        marks["solve"] = time.perf_counter() - t0
        return out

    setattr(S, solver_fn, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, marks["solve"]
    finally:
        setattr(S, solver_fn, solve)


def _timed_run(
    emu, S, solver_fn: str = "mesolve_rk4", fetch: bool = True
) -> tuple[float, float]:
    """Wall seconds of one warm ``run()`` (with the final state fetched if
    ``fetch``), and of its ``S.<solver_fn>`` call up to the device's
    completion."""

    def run():
        res = emu.run()
        if fetch:
            res.get_final_state().full()

    return _timed_call(run, S, solver_fn)


#: RK4 steps of the traced head of a lab-frame solve (its 40 kernel
#: launches per stage over the whole EFF8 run make a trace of about a
#: million events, which takes minutes to read back).
_TRACE_STEPS = 200


def _single_rho_path(S, name: str, make, card: str) -> dict:
    """One master-equation ``run()`` through ``from_sequence`` on the card
    (no shot-to-shot noise): the route, the final ρ against the JAX
    package's figures, then the warm ``run()`` and its solve (median of
    3), the kernel launches per stage and the device's busy share from
    one trace (of the whole warm ``run()`` on the interaction-picture
    grid, of the solve's first :data:`_TRACE_STEPS` steps in the lab
    frame)."""
    from pulser_tpu_torch.emulator import TorchEmulator

    with open(_MESOLVE_GOLDENS[name.lower()]) as f:
        ref = json.load(f)
    _sequence_ms(name, lambda: make()[0], card)
    seq, noise = make()
    captured: dict = {}
    solve, record = _recording(S, "mesolve_rk4", captured)
    S.mesolve_rk4 = record
    try:
        t0 = time.perf_counter()
        emu = TorchEmulator.from_sequence(
            seq, noise_model=noise, evaluation_times="Minimal"
        )
        rho = emu.run().get_final_state().full()
        cold_s = time.perf_counter() - t0
    finally:
        S.mesolve_rk4 = solve
    info = dict(S.last_solve_info)
    print(f"{name} path: {info}, cold {cold_s:.3f} s")
    _check(info.get("kind") == "mesolve_cuda", f"{name} master-equation route")
    _check(info["ip"] == ref["interaction_picture"], f"{name} frame")
    _check(info["n_steps"] == ref["n_steps"], f"{name}: {info['n_steps']}")
    _check(bool(np.isfinite(rho).all()), f"finite {name} state")
    _rho_checks(rho, ref, name)

    runs = [_timed_run(emu, S) for _ in range(3)]
    run_s = statistics.median(r[0] for r in runs)
    solve_s = statistics.median(r[1] for r in runs)
    stages = info["n_steps"] * 4
    if info["ip"]:
        traced_stages = stages
        wall_s, busy_ms, launches = _device_busy(
            lambda: emu.run().get_final_state().full()
        )
        what = f"{name} run()"
    else:
        wall_s, busy_ms, launches, traced_stages = _traced_head(
            S, "mesolve_rk4", captured
        )
        what = f"{name} solve, first {_TRACE_STEPS} steps"
    dim = info["dim"]
    rho_bytes = dim * dim * 8
    print(
        f"times on {card}: warm {name} run() {run_s * 1e3:.3f} ms, its solve"
        f" {solve_s * 1e3:.3f} ms = {solve_s * 1e3 / stages:.4f} ms per RK4"
        f" stage ({stages} stages, {launches / traced_stages:.1f} kernel"
        f" launches per stage); rho {rho_bytes} bytes"
    )
    _print_busy(what, wall_s, busy_ms)
    return _path_entry(
        name, run_s * 1e3, stages, solve_s * 1e3,
        launches * stages / traced_stages, rho_bytes, busy_ms / 1e3 / wall_s,
    )


def _mesolve10_path(S, card: str) -> dict:
    """MESOLVE10 on the card: NOISY10 with ``solver=Solver.MESOLVER``
    through ``from_sequence`` after ``np.random.seed(1234)``, the route,
    the shots, trajectories 0-2 against the JAX package's batch, every
    trajectory's trace; then one warm ``run()`` split into host prep,
    solve, wrapping and sampling, and the busy share from one trace."""
    from pulser_tpu_torch.emulator import Solver, TorchEmulator
    from pulser_tpu_torch.emulator import simulation as sim

    with open(_MESOLVE_GOLDENS["mesolve10"]) as f:
        ref = json.load(f)
    _sequence_ms("MESOLVE10", lambda: mesolve10_sequence()[0], card)
    seq, noise = mesolve10_sequence()
    captured: dict = {}
    solve, record = _recording(S, "mesolve_rk4_batched", captured)
    S.mesolve_rk4_batched = record
    try:
        np.random.seed(ref["seed"])
        t0 = time.perf_counter()
        emu = TorchEmulator.from_sequence(
            seq, noise_model=noise, evaluation_times="Minimal",
            solver=Solver.MESOLVER,
        )
        res = emu.run()
        cold_s = time.perf_counter() - t0
    finally:
        S.mesolve_rk4_batched = solve
    info = dict(S.last_solve_info)
    print(f"MESOLVE10 path: {info}, cold {cold_s:.3f} s")
    _check(info.get("kind") == "mesolve_batched_cuda", "batched master eq.")
    _check(info["ip"] == ref["interaction_picture"], "MESOLVE10 frame")
    _check(info["n_steps"] == ref["n_steps"], f"steps {info['n_steps']}")
    _check(info["n_traj"] == ref["n_traj_batch"], f"{info['n_traj']} traj")
    _check_shots(res)
    states = captured["out"]  # (B, n_eval, dim, dim) complex64
    _check(bool(np.isfinite(states).all()), "finite MESOLVE10 states")
    traces = np.abs(np.trace(states[:, -1], axis1=-2, axis2=-1) - 1)
    print(f"MESOLVE10 final traces: max|tr-1| = {traces.max():.3e}")
    _check(float(traces.max()) <= TRACE_TOL, f"traces {traces.max():.3e}")
    for tr in ref["trajectories"]:
        _rho_checks(
            states[tr["index"], -1], {"n": ref["n"], **tr},
            f"MESOLVE10 trajectory {tr['index']}",
        )

    t0 = time.perf_counter()
    part = _timed_parts(emu, S, sim, "mesolve_rk4_batched")
    warm_s = time.perf_counter() - t0
    stages = info["n_steps"] * 4
    dim, n_traj = info["dim"], info["n_traj"]
    wall_s, busy_ms, launches = _device_busy(emu.run)
    print(
        f"times on {card}: cold MESOLVE10 run() {cold_s * 1e3:.3f} ms, warm"
        f" {warm_s * 1e3:.3f} ms, of which host prep (trajectory draws,"
        f" batch, plan) {part['prep'] * 1e3:.3f} ms, the solve call"
        f" {part['solve'] * 1e3:.3f} ms ="
        f" {part['solve'] * 1e3 / stages:.4f} ms per RK4 stage ({stages}"
        f" stages, {n_traj} trajectories in {info['traj_per_call']} per"
        f" call), wrapping {part['wrap'] * 1e3:.3f} ms, host sampling"
        f" {part['sampling'] * 1e3:.3f} ms; {launches / stages:.1f} kernel"
        f" launches per stage in the traced run"
    )
    _print_busy("MESOLVE10 run()", wall_s, busy_ms)
    return _path_entry(
        "MESOLVE10", warm_s * 1e3, stages, part["solve"] * 1e3, launches,
        n_traj * dim * dim * 8, busy_ms / 1e3 / wall_s,
    )


def _xy16_path(S, card: str) -> dict:
    """XY16 on the card: the lab-frame sesolve with the XY term and the SLM
    mask's interaction interpolation through ``from_sequence``, against
    the JAX package's double-precision run; then the warm ``run()`` and its
    solve (median of 3), the launches per stage and the busy share from a
    trace of the solve's first :data:`_TRACE_STEPS` steps."""
    from pulser_tpu_torch.emulator import TorchEmulator

    ref = np.load(_XY16_GOLDEN)
    _sequence_ms("XY16", xy16_sequence, card)
    captured: dict = {}
    solve, record = _recording(S, "sesolve_rk4", captured)
    S.sesolve_rk4 = record
    try:
        t0 = time.perf_counter()
        emu = TorchEmulator.from_sequence(
            xy16_sequence(), evaluation_times=XY16_EVAL_TIMES
        )
        res = emu.run()
        states = np.stack([s.full()[:, 0] for s in res.states])
        cold_s = time.perf_counter() - t0
    finally:
        S.sesolve_rk4 = solve
    info = dict(S.last_solve_info)
    print(f"XY16 path: {info}, cold {cold_s:.3f} s")
    _check(info.get("kind") == "sesolve_torch_loop", "XY16 torch loop")
    _check(info["ip"] is False, "XY16 lab frame")
    _check(info["n_steps"] == int(ref["n_steps"]), f"steps {info['n_steps']}")
    _check(bool(np.isfinite(states).all()), "finite XY16 states")
    _check(
        np.allclose(res._sim_times, ref["eval_times"]), "XY16 eval times"
    )
    infid = 1 - _fidelity(ref["final"], states[-1])
    norms = np.linalg.norm(states, axis=1)
    norm_err = float(np.abs(norms - ref["norms"]).max())
    probs = np.abs(states.astype(np.complex128)) ** 2
    ones = np.array([bin(i).count("1") for i in range(probs.shape[1])])
    n_d = (probs @ ones) / probs.sum(axis=1)
    free = XY16_EVAL_TIMES >= 0.048  # after the π pulse
    d_err = float(np.abs(n_d - ref["d_excitations"])[free].max())
    print(
        f"XY16 vs the JAX package: final 1-F = {infid:.3e}, norms max|d| ="
        f" {norm_err:.3e} (final norm {norms[-1]:.9f}), d excitations over"
        f" the free exchange {n_d[free].min():.6f}..{n_d[free].max():.6f},"
        f" max|d| = {d_err:.3e}"
    )
    _check(infid <= FIDELITY_TOL, f"XY16 1-F {infid:.3e}")
    _check(norm_err <= XY_TOL, f"XY16 norms {norm_err:.3e}")
    _check(d_err <= XY_TOL, f"XY16 d excitations {d_err:.3e}")

    runs = [_timed_run(emu, S, "sesolve_rk4") for _ in range(3)]
    run_s = statistics.median(r[0] for r in runs)
    solve_s = statistics.median(r[1] for r in runs)
    stages = info["n_steps"] * 4
    wall_s, busy_ms, launches, traced = _traced_head(S, "sesolve_rk4", captured)
    state_bytes = info["dim"] * 8
    print(
        f"times on {card}: warm XY16 run() {run_s * 1e3:.3f} ms, its solve"
        f" {solve_s * 1e3:.3f} ms = {solve_s * 1e3 / stages:.4f} ms per RK4"
        f" stage ({stages} stages, {launches / traced:.1f} kernel launches"
        f" per stage); state {state_bytes} bytes"
    )
    _print_busy(f"XY16 solve, first {_TRACE_STEPS} steps", wall_s, busy_ms)
    return _path_entry(
        "XY16", run_s * 1e3, stages, solve_s * 1e3, launches * stages / traced,
        state_bytes, busy_ms / 1e3 / wall_s,
    )


def _relax10_path(K, S, card: str) -> dict:
    """RELAX10 on the card: the batched quantum-jump torch scan through
    ``from_sequence`` after ``np.random.seed(1234)``, against the JAX
    package's figures for the same seed (counts TV ≤ 0.02, per-trajectory
    final Rydberg populations within 1e-3 for all trajectories but at most
    one); then the warm ``run()`` and its solve (median of 3), and the
    launches per stage and busy share from one traced warm ``run()``."""
    with open(_MCWF_GOLDENS["relax10"]) as f:
        ref = json.load(f)
    _sequence_ms("RELAX10", lambda: relax10_sequence()[0], card)
    emu, res, launches, cold_s, captured = _run_noisy(
        K, relax10_sequence(), ref["seed"], "mcsolve_rk4_batched", S
    )
    info = dict(S.last_solve_info)
    print(f"RELAX10 path: {info}, cold {cold_s:.3f} s, kernel launches {launches}")
    _check(info.get("kind") == "mcwf_batched_torch", "RELAX10 torch scan")
    _check(info["ip"] is True, "RELAX10 interaction picture")
    _check(info["n_steps"] == ref["n_steps"], f"steps {info['n_steps']}")
    _check(not any(launches.values()), f"no kernel on RELAX10: {launches}")
    _check_shots(res)
    states = captured["out"]  # (B, n_eval, dim)
    _check(bool(np.isfinite(states).all()), "finite RELAX10 states")
    n = info["n"]
    pops = _rydberg_populations(np.abs(states[:, -1]) ** 2, n)
    per_traj = np.abs(pops - np.asarray(ref["rydberg_populations"])).max(1)
    odd = np.flatnonzero(per_traj > POPULATION_TOL).tolist()
    tv = _tv_distance(res[-1].bitstring_counts, ref["final_counts"])
    print(
        f"RELAX10 vs the JAX package: per-trajectory populations max|d| ="
        f" {np.median(per_traj):.3e} (median), trajectories beyond"
        f" {POPULATION_TOL}: {odd}; final counts TV = {tv:.4f}"
    )
    _check(len(odd) <= 1, f"RELAX10 trajectories {odd}")
    _check(tv <= COUNTS_TV_TOL, f"RELAX10 counts TV {tv:.4f}")

    runs = [
        _timed_run(emu, S, "mcsolve_rk4_batched", fetch=False)
        for _ in range(3)
    ]
    run_s = statistics.median(r[0] for r in runs)
    solve_s = statistics.median(r[1] for r in runs)
    stages = info["n_steps"] * 4
    wall_s, busy_ms, n_launch = _device_busy(emu.run)
    state_bytes = info["n_traj"] * info["dim"] * 8
    print(
        f"times on {card}: warm RELAX10 run() {run_s * 1e3:.3f} ms, its"
        f" solve {solve_s * 1e3:.3f} ms = {solve_s * 1e3 / stages:.4f} ms"
        f" per RK4 stage ({stages} stages, {info['n_traj']} trajectories in"
        f" {info['traj_per_call']} per call, {n_launch / stages:.1f} kernel"
        f" launches per stage in the traced run); states {state_bytes} bytes"
    )
    _print_busy("RELAX10 run()", wall_s, busy_ms)
    return _path_entry(
        "RELAX10", run_s * 1e3, stages, solve_s * 1e3, n_launch, state_bytes,
        busy_ms / 1e3 / wall_s,
    )


def _mcdepol10_path(S, card: str) -> dict:
    """MCDEPOL10 on the card: the serial quantum-jump solve of 100
    trajectories in the lab frame through ``from_sequence`` with
    ``solver=Solver.MCSOLVER`` after ``np.random.seed(1234)``; the averaged
    final ρ's trace, Hermiticity and Rydberg populations (within 2e-2 of
    the JAX package's); then the warm ``run()`` and its solve (median of
    3), and the launches per stage and busy share from a trace of the
    solve's first :data:`_TRACE_STEPS` steps."""
    from pulser_tpu_torch.emulator import Solver, TorchEmulator

    with open(_MCWF_GOLDENS["mcdepol10"]) as f:
        ref = json.load(f)
    _sequence_ms("MCDEPOL10", lambda: mcdepol10_sequence()[0], card)
    seq, noise = mcdepol10_sequence()
    captured: dict = {}
    solve, record = _recording(S, "mcsolve_rk4", captured)
    S.mcsolve_rk4 = record
    try:
        np.random.seed(ref["seed"])
        t0 = time.perf_counter()
        emu = TorchEmulator.from_sequence(
            seq, noise_model=noise, evaluation_times="Minimal",
            solver=Solver.MCSOLVER, n_trajectories=ref["ntraj"],
        )
        rho = emu.run().get_final_state().full()
        cold_s = time.perf_counter() - t0
    finally:
        S.mcsolve_rk4 = solve
    info = dict(S.last_solve_info)
    print(f"MCDEPOL10 path: {info}, cold {cold_s:.3f} s")
    _check(info.get("kind") == "mcwf_serial_torch", "MCDEPOL10 serial solve")
    _check(info["ip"] is False, "MCDEPOL10 lab frame")
    _check(info["n_traj"] == ref["ntraj"], f"{info['n_traj']} trajectories")
    _check(info["n_steps"] == ref["n_steps"], f"steps {info['n_steps']}")
    _check(bool(np.isfinite(rho).all()), "finite MCDEPOL10 state")
    rho = np.asarray(rho, dtype=np.complex128)
    trace_err = abs(np.trace(rho) - 1.0)
    herm_err = float(np.abs(rho - rho.conj().T).max())
    pops = _rydberg_populations(np.real(np.diag(rho))[None], ref["n"])[0]
    pop_err = float(np.abs(pops - ref["rydberg_populations"]).max())
    print(
        f"MCDEPOL10 vs the JAX package: |tr-1| = {trace_err:.3e}, max|rho -"
        f" rho^H| = {herm_err:.3e}, Rydberg populations max|d| ="
        f" {pop_err:.3e}"
    )
    _check(trace_err <= TRACE_TOL, f"MCDEPOL10 trace {trace_err:.3e}")
    _check(herm_err <= HERMITIAN_TOL, f"MCDEPOL10 Hermitian {herm_err:.3e}")
    _check(pop_err <= MC_POPULATION_TOL, f"MCDEPOL10 populations {pop_err:.3e}")

    runs = [_timed_run(emu, S, "mcsolve_rk4") for _ in range(3)]
    run_s = statistics.median(r[0] for r in runs)
    solve_s = statistics.median(r[1] for r in runs)
    stages = info["n_steps"] * 4
    wall_s, busy_ms, launches, traced = _traced_head(S, "mcsolve_rk4", captured)
    state_bytes = info["n_traj"] * info["dim"] * 8
    print(
        f"times on {card}: warm MCDEPOL10 run() {run_s * 1e3:.3f} ms, its"
        f" solve {solve_s * 1e3:.3f} ms = {solve_s * 1e3 / stages:.4f} ms per"
        f" RK4 stage ({stages} stages, {info['n_traj']} trajectories in"
        f" {info['traj_per_call']} per call, {launches / traced:.1f} kernel"
        f" launches per stage); states {state_bytes} bytes, averaged rho"
        f" {2 * info['dim'] ** 2 * 8} bytes"
    )
    _print_busy(f"MCDEPOL10 solve, first {_TRACE_STEPS} steps", wall_s, busy_ms)
    return _path_entry(
        "MCDEPOL10", run_s * 1e3, stages, solve_s * 1e3,
        launches * stages / traced, state_bytes, busy_ms / 1e3 / wall_s,
    )


#: The JAX package's run of NOISY10 through its backend API after
#: ``np.random.seed(1234)`` (the observables of
#: :func:`_backend_noisy10_observables`; row-batched quantum-jump kernel in
#: the Pallas interpreter on a CPU, single precision), written by
#: ``JAX_PLATFORMS=cpu PYTHONPATH=. python tools/backend_references.py``:
#: the mean occupations, the mean energy, the aggregated ρ's diagonal and
#: trace, and the final counts.
_BACKEND_NOISY10_GOLDEN = os.path.join(
    _ROOT, "tests", "goldens", "backend_noisy10_reference.json"
)
#: The backend's Occupation against the populations of ``run()``'s states
#: (the same solve: float32 state, complex128 arithmetic on both sides).
BACKEND_OCCUPATION_TOL = 1e-6
#: ... and against the golden's final state (an independent float64 run).
BACKEND_GOLDEN_OCCUPATION_TOL = 1e-5
#: Its 1000 shots against the same shots drawn from the golden's
#: probabilities with the same uniforms (total variation).
BACKEND_COUNTS_TV_TOL = 0.01
#: The backend's peak device memory on AFM16: far below one 2^16 x 2^16
#: matrix (64 GB in complex128), so none was formed.
BACKEND_PEAK_BYTES = 2 << 30
#: NOISY10 through the backend against the JAX package's: the mean
#: occupations (absolute), the energy (relative), the aggregated ρ's
#: diagonal (absolute).
BACKEND_NOISY_TOL = 1e-3


def _backend_afm16_observables():
    """The AFM16 backend configuration's observables: the state and the
    occupations at 101 evenly spaced relative times, the correlation
    matrix, the energy and 1000 shots at the end."""
    from pulser_tpu_torch import (
        BitStrings,
        CorrelationMatrix,
        Energy,
        Occupation,
        StateResult,
    )

    times = np.linspace(0, 1, 101)
    return [
        StateResult(evaluation_times=times),
        Occupation(evaluation_times=times),
        CorrelationMatrix(evaluation_times=[1.0]),
        Energy(evaluation_times=[1.0]),
        BitStrings(evaluation_times=[1.0], num_shots=1000),
    ]


def _backend_noisy10_observables(P=None):
    """NOISY10's backend observables (as ``tools/backend_references.py``):
    the occupations at 0.5 and 1.0, the energy and the state (aggregated
    into ρ) at 1.0, and 1000 shots at 1.0 with the SPAM readout errors;
    ``P`` as for the sequence builders."""
    if P is None:
        import pulser_tpu_torch as P
    BitStrings, Energy = P.backend.BitStrings, P.backend.Energy
    Occupation, StateResult = P.backend.Occupation, P.backend.StateResult

    return [
        Occupation(evaluation_times=[0.5, 1.0]),
        Energy(evaluation_times=[1.0]),
        StateResult(evaluation_times=[1.0]),
        BitStrings(evaluation_times=[1.0], num_shots=1000),
    ]


def _median_timed_call(fn, S, solver_fn: str) -> tuple[float, float]:
    """:func:`_timed_call`'s two times, median of 3 each."""
    runs = [_timed_call(fn, S, solver_fn) for _ in range(3)]
    return (
        statistics.median(r[0] for r in runs),
        statistics.median(r[1] for r in runs),
    )


def _backend_run(K, backend, kernel: str) -> tuple:
    """One ``backend.run()`` with the launch counters set to 0 just before
    and read just after, and the device's own count of ``kernel``'s
    launches; returns ``(results, wrapper launches, device launches,
    seconds)``."""
    import torch

    torch.cuda.synchronize()
    _reset_launches(K)
    before = K.device_launches(kernel)
    t0 = time.perf_counter()
    res = backend.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (
        res, _launches(K)[kernel], K.device_launches(kernel) - before, seconds
    )


def _observable_seconds():
    """A context that times every observable call and ``Results.aggregate``
    (host seconds, the device synchronized at each end)."""
    import contextlib

    import torch

    from pulser_tpu_torch.backend.observable import Observable
    from pulser_tpu_torch.backend.results import Results

    spent = {"observables": 0.0, "aggregate": 0.0}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out

        return wrapper

    @contextlib.contextmanager
    def ctx():
        call, agg = Observable.__call__, Results.__dict__["aggregate"]
        Observable.__call__ = timed(call, "observables")
        Results.aggregate = classmethod(timed(agg.__func__, "aggregate"))
        try:
            yield spent
        finally:
            Observable.__call__ = call
            Results.aggregate = agg

    return ctx()


def _backend_afm16_path(K, S, card: str) -> dict:
    """AFM16 through ``TorchBackendV2(seq, config=TorchConfig(...)).run()``
    on the card: one K1 launch; the state, occupations, correlations,
    energy and shots against the golden and against ``run()``'s own states;
    the peak device memory; the warm times and the busy share."""
    import torch

    from pulser_tpu_torch.emulator import TorchBackendV2, TorchConfig, TorchState
    from pulser_tpu_torch.ops.apply import hamiltonian_matvec

    _sequence_ms("BACKEND_AFM16", afm16_sequence, card)
    golden = np.load(_GOLDEN)["final_state"]
    config = TorchConfig(observables=_backend_afm16_observables())
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    backend = TorchBackendV2(afm16_sequence(), config=config)
    np.random.seed(1234)
    # The numpy RNG's state where the shots start (the run draws the
    # noiseless trajectory before them)
    shots_rng: list = []
    sample = TorchState.sample

    def recording(self, **kwargs):
        shots_rng.append(np.random.get_state())
        return sample(self, **kwargs)

    TorchState.sample = recording
    try:
        res, launches, device_launches, run_s = _backend_run(
            K, backend, "ip_sesolve"
        )
    finally:
        TorchState.sample = sample
    cold_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    info = dict(S.last_solve_info)
    print(
        f"BACKEND_AFM16: {info}, launches={launches} (device"
        f" {device_launches}), cold {cold_s:.3f} s; peak device memory"
        f" {peak / 2**20:.1f} MiB ({(peak - base_bytes) / 2**20:.1f} MiB over"
        f" the {base_bytes / 2**20:.1f} MiB held before) [{card}]"
    )
    _check(info.get("kind") == "ip_sesolve_cuda", "backend K1 route")
    _check(launches == 1 and device_launches == 1, "one K1 launch per run")
    _check(peak < BACKEND_PEAK_BYTES, f"peak memory {peak} B")
    times = res.get_result_times("occupation")
    _check(len(times) == 101, "101 occupation times")
    _check(res.get_result_times("state") == times, "state times")
    final = res.final_state
    _check(isinstance(final, TorchState), "final state type")
    _check(final.to_tensor().device.type == "cuda", "states stay on the card")
    fin = final.to_qobj().full()[:, 0]
    _check(fin.shape == (1 << 16,) and bool(np.isfinite(fin).all()), "final")
    infid = 1 - _fidelity(golden, fin)
    occ = np.array(res.occupation, dtype=float)
    probs_g = np.abs(golden / np.linalg.norm(golden)) ** 2
    occ_golden = _rydberg_populations(probs_g[None], 16)[0]
    golden_occ_err = float(np.abs(occ[-1] - occ_golden).max())

    # The same solve's states from run(): their populations at every time
    emu = backend._sim_obj
    states = np.stack([s.full()[:, 0] for s in emu.run().states])
    probs = np.abs(states.astype(np.complex128)) ** 2
    probs /= probs.sum(axis=1, keepdims=True)
    run_occ_err = float(np.abs(occ - _rydberg_populations(probs, 16)).max())
    corr = np.array(res.correlation_matrix[-1], dtype=float)
    corr_sym = float(np.abs(corr - corr.T).max())
    corr_diag = float(np.abs(np.diag(corr) - occ[-1]).max())

    ham = emu._get_noiseless_hamiltonian(False)
    amp, det = ham._coeffs_at(emu.total_duration_ns * 1e-3)
    dev = torch.device("cuda")

    def h_expect(state: np.ndarray) -> tuple[float, float]:
        """⟨ψ|H|ψ⟩ and ‖Hψ‖ of the normalized ``state``."""
        psi = torch.from_numpy(state / np.linalg.norm(state)).to(dev)
        h_psi = hamiltonian_matvec(
            psi,
            torch.from_numpy(np.asarray(ham.int_diag, np.float64)).to(dev),
            torch.from_numpy(np.asarray(amp, np.complex128)).to(dev),
            torch.from_numpy(np.asarray(det, np.float64).real).to(dev),
            ham.pairs, 2, 16,
        )
        return (
            float(torch.vdot(psi, h_psi).real),
            float(torch.linalg.vector_norm(h_psi)),
        )

    energy = float(res.energy[-1])
    energy_ref, h_psi_norm = h_expect(golden)
    energy_rel = abs(energy - energy_ref) / abs(energy_ref)
    # The observable itself: the same product on the run's own state
    energy_own_rel = abs(energy - h_expect(fin)[0]) / abs(energy)
    # What the state's own distance to the golden allows: with
    # ‖δ‖ ≤ √(2(1 − F)) after the best phase, |Δ⟨H⟩| ≤ 2‖δ‖‖Hψ‖ + ‖δ‖²‖H‖
    # (‖H‖ bounded by its diagonal and its drives at the end)
    h_norm = float(
        np.abs(ham.int_diag).max()
        + np.abs(det).sum()
        + 2 * np.abs(amp).sum()
    )
    delta = np.sqrt(2 * max(infid, 0.0))
    energy_allowed = 2 * delta * h_psi_norm + delta**2 * h_norm

    _check(len(shots_rng) == 1, "one BitStrings sample")
    np.random.set_state(shots_rng[0])
    ref_counts = TorchState(
        torch.from_numpy(golden), eigenstates=("r", "g")
    ).sample(num_shots=1000)
    tv = _tv_distance(res.final_bitstrings, ref_counts)
    print(
        f"BACKEND_AFM16 checks: final 1-F vs golden {infid:.3e}; occupation"
        f" vs run()'s states max|d| {run_occ_err:.3e} (101 times), final vs"
        f" golden {golden_occ_err:.3e}; correlation asymmetry {corr_sym:.3e},"
        f" diagonal vs occupation {corr_diag:.3e}; energy {energy:.9f} vs"
        f" <psi|H|psi> on the golden {energy_ref:.9f} (rel {energy_rel:.3e};"
        f" |d| {abs(energy - energy_ref):.3e}, allowed by the state's 1-F"
        f" {energy_allowed:.3e} with |H psi| {h_psi_norm:.6f}), on the run's"
        f" own final state rel {energy_own_rel:.3e};"
        f" shots TV vs the golden's {tv:.4f}"
    )
    _check(infid < FIDELITY_TOL, f"backend final 1-F {infid:.3e}")
    _check(run_occ_err <= BACKEND_OCCUPATION_TOL, "occupation vs run()")
    _check(golden_occ_err <= BACKEND_GOLDEN_OCCUPATION_TOL, "occupation")
    _check(corr_sym <= 1e-12, f"correlation symmetric {corr_sym:.3e}")
    _check(corr_diag <= 1e-12, f"correlation diagonal {corr_diag:.3e}")
    _check(energy_own_rel <= 1e-10, f"energy on its state {energy_own_rel:.3e}")
    _check(
        abs(energy - energy_ref) <= energy_allowed,
        f"energy vs golden {abs(energy - energy_ref):.3e}",
    )
    _check(sum(res.final_bitstrings.values()) == 1000, "1000 shots")
    _check(tv <= BACKEND_COUNTS_TV_TOL, f"shots TV {tv:.4f}")

    backend_s, solve_s = _median_timed_call(backend.run, S, "sesolve_rk4")
    run_only_s, _ = _median_timed_call(
        lambda: emu.run().states[-1].full(), S, "sesolve_rk4"
    )
    with _observable_seconds() as spent:
        backend.run()
    wall_s, busy_ms, _ = _device_busy(backend.run)
    stages = info["n_steps"] * 4
    print(
        f"times on {card}: warm backend run() {backend_s * 1e3:.3f} ms"
        f" (median of 3), of which the K1 solve {solve_s * 1e3:.3f} ms and"
        f" the observables {spent['observables'] * 1e3:.3f} ms (101"
        f" evaluation times); warm emulator run() with the final state"
        f" fetched {run_only_s * 1e3:.3f} ms"
    )
    _print_busy("backend AFM16 run()", wall_s, busy_ms)
    entry = _path_entry(
        "BACKEND_AFM16", backend_s * 1e3, stages, solve_s * 1e3,
        device_launches, (1 << 16) * 8, busy_ms / 1e3 / wall_s,
    )
    entry.update(
        peak_bytes=peak,
        run_ms=run_only_s * 1e3,
        observables_ms=spent["observables"] * 1e3,
        launches={"ip_sesolve": launches},
    )
    return entry


def _backend_noisy10_path(K, S, card: str) -> dict:
    """NOISY10 through ``TorchBackendV2`` on the card: one K2 launch; the
    occupations, energy, aggregated ρ and shots against the JAX package's
    backend run; the host time of the observables, the warm time and the
    busy share."""
    import torch

    from pulser_tpu_torch.emulator import TorchBackendV2, TorchConfig

    with open(_BACKEND_NOISY10_GOLDEN) as fh:
        ref = json.load(fh)
    _sequence_ms("BACKEND_NOISY10", lambda: noisy10_sequence()[0], card)
    seq, noise = noisy10_sequence()
    with warnings.catch_warnings():
        # The noise model's samples_per_run is ignored by the backend
        warnings.simplefilter("ignore", UserWarning)
        config = TorchConfig(
            observables=_backend_noisy10_observables(),
            noise_model=noise,
            n_trajectories=ref["n_trajectories"],
        )
    t0 = time.perf_counter()
    np.random.seed(ref["seed"])
    backend = TorchBackendV2(seq, config=config)
    res, launches, device_launches, _ = _backend_run(K, backend, "mcwf_rows")
    cold_s = time.perf_counter() - t0
    info = dict(S.last_solve_info)
    print(
        f"BACKEND_NOISY10: {info}, launches={launches} (device"
        f" {device_launches}), cold {cold_s:.3f} s [{card}]"
    )
    _check(info.get("kind") == "mcwf_rows_cuda", "backend K2 route")
    _check(launches == 1 and device_launches == 1, "one K2 launch per run")
    _check(info["n_steps"] == ref["n_steps"], f"steps {info['n_steps']}")
    occ_err = max(
        float(np.abs(np.array(res.get_result("occupation", t)) - want).max())
        for t, want in zip(ref["occupation_times"], ref["occupation"])
    )
    energy = float(res.energy[-1])
    energy_rel = abs(energy - ref["energy"]) / abs(ref["energy"])
    rho = res.final_state.to_qobj().full()
    trace_err = abs(np.trace(rho).real - 1)
    herm_err = float(np.abs(rho - rho.conj().T).max())
    diag_err = float(np.abs(np.diag(rho).real - ref["rho_diagonal"]).max())
    counts = res.final_bitstrings
    tv = _tv_distance(counts, ref["final_counts"])
    print(
        f"BACKEND_NOISY10 vs the JAX package's backend (seed {ref['seed']}):"
        f" occupations max|d| {occ_err:.3e}; energy {energy:.6f} vs"
        f" {ref['energy']:.6f} (rel {energy_rel:.3e}); aggregated rho"
        f" {rho.shape}: |tr-1| {trace_err:.3e}, Hermitian to {herm_err:.3e},"
        f" diagonal max|d| {diag_err:.3e}; counts TV {tv:.4f}"
        f" ({sum(counts.values())} shots)"
    )
    _check(rho.shape == (1024, 1024), "aggregated rho shape")
    _check(occ_err <= BACKEND_NOISY_TOL, f"occupations {occ_err:.3e}")
    _check(energy_rel <= BACKEND_NOISY_TOL, f"energy rel {energy_rel:.3e}")
    _check(trace_err <= TRACE_TOL, f"trace {trace_err:.3e}")
    _check(herm_err <= HERMITIAN_TOL, f"Hermitian {herm_err:.3e}")
    _check(diag_err <= BACKEND_NOISY_TOL, f"rho diagonal {diag_err:.3e}")
    _check(sum(counts.values()) == 100 * 1000, "1000 shots per trajectory")
    _check(tv <= COUNTS_TV_TOL, f"counts TV {tv:.4f}")

    def warm():
        np.random.seed(ref["seed"])
        return backend.run()

    backend_s, solve_s = _median_timed_call(warm, S, "mcsolve_rk4_batched")
    with _observable_seconds() as spent:
        warm()
    wall_s, busy_ms, _ = _device_busy(warm)
    n_evals = len(backend._sim_obj.evaluation_times)
    stages = info["n_steps"] * 4
    print(
        f"times on {card}: warm backend run() {backend_s * 1e3:.3f} ms"
        f" (median of 3), of which the K2 solve with its fetch"
        f" {solve_s * 1e3:.3f} ms, the observables"
        f" {spent['observables'] * 1e3:.3f} ms ({ref['n_trajectories']}"
        f" trajectories x {n_evals} evaluation times) and the aggregation"
        f" {spent['aggregate'] * 1e3:.3f} ms"
    )
    _print_busy("backend NOISY10 run()", wall_s, busy_ms)
    entry = _path_entry(
        "BACKEND_NOISY10", backend_s * 1e3, stages, solve_s * 1e3,
        device_launches, ref["n_trajectories"] * 1024 * 8,
        busy_ms / 1e3 / wall_s,
    )
    entry.update(
        observables_ms=spent["observables"] * 1e3,
        aggregate_ms=spent["aggregate"] * 1e3,
        launches={"mcwf_rows": launches},
    )
    return entry


# -- the wire: abstract-repr JSON in, the card's run out ---------------------

#: The seed and the trajectory count of NOISY10's backend runs, the wire's
#: included (as ``tests/goldens/backend_noisy10_reference.json``).
NOISY10_SEED = 1234
NOISY10_TRAJECTORIES = 100
#: The shots WIRE_TRI16's job asks the QPU for, and the seed its
#: server samples them with.
TRI16_RUNS = 500
TRI16_SEED = 1234
#: The sha256 of the sequence payloads the wire paths send
#: (:func:`wire_payloads`); ``tests/test_torch_json.py`` validates the same
#: payloads against the schemas on the CPU and holds them to these hashes.
WIRE_PAYLOAD_SHA256 = {
    "WIRE_AFM16": (
        "26e2c871f8142aba89ee68f71810274c5f5ee112da1758e9d3115e61764fee27"
    ),
    "WIRE_NOISY10": (
        "3b92dfbb6ee32930297f6e4d2b5e7072047a9b9b4a749ea602c2f8d3123bb187"
    ),
    "WIRE_TRI16": (
        "320538622a8b9a042a3f4c697f3c10cf0bf1e825d7a1e9c1d78a5da0fa071147"
    ),
}
#: A final state decoded from the wire against the direct build's.
WIRE_FIDELITY_TOL = 1e-12


def _sha256(text: str) -> str:
    import hashlib

    return hashlib.sha256(text.encode()).hexdigest()


def _wire_noisy10_observables(P=None):
    """BACKEND_NOISY10's observables that the wire carries: the
    occupations at 0.5 and 1.0, the energy at 1.0 and 1000 shots per
    trajectory at 1.0 (its ``StateResult`` has no abstract repr: the
    encoder refuses it, as every remote backend does)."""
    return [
        obs
        for obs in _backend_noisy10_observables(P)
        if type(obs).__name__ != "StateResult"
    ]


def wire_noisy10_config(noise, P=None):
    """NOISY10's ``EmulationConfig`` as a client writes it: the noise
    model, the wire's observables and the trajectory count. (The seed is
    the job's, not the config's: ``TorchConfig``, like the JAX package's
    ``TpuConfig``, refuses options it does not know.)"""
    if P is None:
        import pulser_tpu_torch as P

    with warnings.catch_warnings():
        # The noise model's samples_per_run is ignored by the backend
        warnings.simplefilter("ignore", UserWarning)
        return P.backend.EmulationConfig(
            observables=_wire_noisy10_observables(P),
            noise_model=noise,
            n_trajectories=NOISY10_TRAJECTORIES,
        )


def wire_payloads() -> dict:
    """The abstract-repr sequences the wire paths send: AFM16's and
    NOISY10's as ``to_abstract_repr()`` writes them, and TRI16's as
    ``QPUBackend`` submits it (with the measurement that
    ``RemoteConnection._add_measurement_to_sequence`` adds)."""
    from pulser_tpu_torch.backend.remote import RemoteConnection

    return {
        "WIRE_AFM16": afm16_sequence().to_abstract_repr(),
        "WIRE_NOISY10": noisy10_sequence()[0].to_abstract_repr(),
        "WIRE_TRI16": RemoteConnection._add_measurement_to_sequence(
            tri16_sequence()
        ).to_abstract_repr(),
    }


def _check_payload(name: str, payload: str) -> None:
    got = _sha256(payload)
    _check(
        got == WIRE_PAYLOAD_SHA256[name],
        f"{name} payload sha256 {got} != {WIRE_PAYLOAD_SHA256[name]}",
    )


def _check_samples_equal(got_seq, want_seq, what: str) -> None:
    """Fails unless two sequences' samples are bit-equal."""
    from pulser_tpu_torch import sample

    got_s, want_s = sample(got_seq), sample(want_seq)
    _check(
        set(got_s.channel_samples) == set(want_s.channel_samples),
        f"{what} channels",
    )
    for ch, cs in want_s.channel_samples.items():
        for field in ("amp", "det", "phase"):
            _check(
                np.array_equal(
                    np.asarray(getattr(got_s.channel_samples[ch], field)),
                    np.asarray(getattr(cs, field)),
                ),
                f"{what} {ch}.{field} samples bit-equal to the direct build",
            )


def _wire_ms(payload: str, seq, load) -> tuple[float, float]:
    """Host ms to write ``seq`` as abstract-repr JSON and to load
    ``payload`` back (validation included), median of 3 each."""
    return (
        _median_seconds(seq.to_abstract_repr) * 1e3,
        _median_seconds(lambda: load(payload)) * 1e3,
    )


def _wire_afm16_path(K, S, card: str) -> dict:
    """AFM16 through the wire: the sequence is written as abstract-repr
    JSON, loaded back with ``Sequence.from_abstract_repr`` and run with
    ``TorchEmulator.from_sequence(...).run()``: samples bit-equal to the
    direct build's, one K1 launch, the final state equal to the direct
    run's and within the golden's tolerance."""
    import torch

    from pulser_tpu_torch import Sequence
    from pulser_tpu_torch.emulator import TorchEmulator

    direct = afm16_sequence()
    payload = direct.to_abstract_repr()
    _check_payload("WIRE_AFM16", payload)
    ser_ms, de_ms = _wire_ms(payload, direct, Sequence.from_abstract_repr)
    seq = Sequence.from_abstract_repr(payload)
    _check_samples_equal(seq, direct, "WIRE_AFM16")
    eval_times = np.linspace(0, seq.get_duration() * 1e-3, 101)
    fin_direct = (
        TorchEmulator.from_sequence(direct, evaluation_times=eval_times)
        .run()
        .states[-1]
        .full()[:, 0]
    )
    torch.cuda.synchronize()
    _reset_launches(K)
    c_before = K.device_launches("ip_sesolve")
    t0 = time.perf_counter()
    res = TorchEmulator.from_sequence(seq, evaluation_times=eval_times).run()
    fin = res.states[-1].full()[:, 0]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launches(K)
    c_launches = K.device_launches("ip_sesolve") - c_before
    info = dict(S.last_solve_info)
    vs_direct = 1 - _fidelity(fin_direct, fin)
    vs_golden = 1 - _fidelity(np.load(_GOLDEN)["final_state"], fin)
    print(
        f"WIRE_AFM16: {len(payload)} bytes of JSON (sha256 ok), serialize"
        f" {ser_ms:.3f} ms, deserialize {de_ms:.3f} ms (host, median of 3);"
        f" {info.get('kind')}, launches={launches} (device {c_launches}),"
        f" run {run_s * 1e3:.3f} ms; 1-F vs the direct run {vs_direct:.3e},"
        f" vs the golden {vs_golden:.3e} [{card}]",
        flush=True,
    )
    _check(info.get("kind") == "ip_sesolve_cuda", "WIRE_AFM16 takes K1")
    _check(launches["ip_sesolve"] == 1, "one K1 launch on WIRE_AFM16")
    _check(c_launches == 1, "one K1 device launch by the library's count")
    _check(sum(launches.values()) == 1, f"no other kernel: {launches}")
    _check(bool(np.isfinite(fin).all()), "WIRE_AFM16 final state finite")
    _check(vs_direct <= WIRE_FIDELITY_TOL, f"vs direct 1-F {vs_direct:.3e}")
    _check(vs_golden <= FIDELITY_TOL, f"vs golden 1-F {vs_golden:.3e}")
    return {
        "name": "WIRE_AFM16",
        "ms": run_s * 1e3,
        "serialize_ms": ser_ms,
        "deserialize_ms": de_ms,
        "payload_bytes": len(payload),
        "launches": {"ip_sesolve": launches["ip_sesolve"]},
        "one_minus_f_vs_direct": vs_direct,
        "one_minus_f_vs_golden": vs_golden,
    }


def _as_numpy(value) -> np.ndarray:
    import torch

    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _wire_noisy10_path(K, S, card: str) -> dict:
    """NOISY10 through the wire: its sequence and its ``EmulationConfig``
    (noise model, observables, trajectories) are written as abstract-repr
    JSON, loaded back and run with ``TorchBackendV2`` seeded with
    :data:`NOISY10_SEED`: one K2 launch, the occupations and counts equal
    to the same backend run built directly with the same seed, and the
    results' own abstract repr loads back to equal values."""
    from pulser_tpu_torch import EmulationConfig, Sequence
    from pulser_tpu_torch.backend.results import Results
    from pulser_tpu_torch.emulator import TorchBackendV2

    direct, noise = noisy10_sequence()
    payload = direct.to_abstract_repr()
    _check_payload("WIRE_NOISY10", payload)
    direct_config = wire_noisy10_config(noise)
    config_json = direct_config.to_abstract_repr()
    ser_ms, de_ms = _wire_ms(payload, direct, Sequence.from_abstract_repr)
    seq = Sequence.from_abstract_repr(payload)
    config = EmulationConfig.from_abstract_repr(config_json)
    _check(config.noise_model == noise, "WIRE_NOISY10 noise model")
    _check(
        config.to_abstract_repr() == config_json,
        "WIRE_NOISY10 config writes back unchanged",
    )
    _check_samples_equal(seq, direct, "WIRE_NOISY10")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # samples_per_run
        np.random.seed(NOISY10_SEED)
        want = TorchBackendV2(direct, config=direct_config).run()
        np.random.seed(NOISY10_SEED)
        backend = TorchBackendV2(seq, config=config)
    res, launches, device_launches, run_s = _backend_run(
        K, backend, "mcwf_rows"
    )
    info = dict(S.last_solve_info)
    occ_err = max(
        float(
            np.abs(
                _as_numpy(res.get_result("occupation", t))
                - _as_numpy(want.get_result("occupation", t))
            ).max()
        )
        for t in (0.5, 1.0)
    )
    counts, want_counts = res.final_bitstrings, want.final_bitstrings
    tv = _tv_distance(counts, want_counts)
    t0 = time.perf_counter()
    results_json = res.to_abstract_repr()
    back = Results.from_abstract_repr(results_json)
    results_ms = (time.perf_counter() - t0) * 1e3
    back_ok = back.get_result_tags() == res.get_result_tags() and all(
        np.array_equal(
            _as_numpy(back.get_result(tag, t)),
            _as_numpy(res.get_result(tag, t)),
        )
        for tag in ("occupation", "energy")
        for t in res.get_result_times(tag)
    ) and dict(back.final_bitstrings) == dict(counts)
    print(
        f"WIRE_NOISY10: sequence {len(payload)} bytes (sha256 ok), config"
        f" {len(config_json)} bytes; serialize {ser_ms:.3f} ms, deserialize"
        f" {de_ms:.3f} ms (host, median of 3); {info.get('kind')},"
        f" launches={launches} (device {device_launches}), run"
        f" {run_s * 1e3:.3f} ms; vs the direct backend run: occupations"
        f" max|d| {occ_err:.3e}, counts TV {tv:.4f}; results JSON"
        f" {len(results_json)} bytes written and loaded in"
        f" {results_ms:.3f} ms, equal {back_ok} [{card}]",
        flush=True,
    )
    _check(info.get("kind") == "mcwf_rows_cuda", "WIRE_NOISY10 takes K2")
    _check(launches == 1 and device_launches == 1, "one K2 launch")
    _check(occ_err == 0.0, f"WIRE_NOISY10 occupations {occ_err:.3e}")
    _check(tv == 0.0, f"WIRE_NOISY10 counts TV {tv:.4f}")
    _check(
        sum(counts.values()) == NOISY10_TRAJECTORIES * 1000,
        "1000 shots per trajectory",
    )
    _check(back_ok, "WIRE_NOISY10 results load back to equal values")
    return {
        "name": "WIRE_NOISY10",
        "ms": run_s * 1e3,
        "serialize_ms": ser_ms,
        "deserialize_ms": de_ms,
        "payload_bytes": len(payload),
        "results_json_ms": results_ms,
        "launches": {"mcwf_rows": launches},
        "occupation_max_abs_diff": occ_err,
        "counts_tv": tv,
    }


def chip_connection(torch_device=None):
    """A ``RemoteConnection`` whose far end is this process and the card
    (or ``torch_device``): it lists ``AnalogDevice`` as decoded from its
    abstract repr, takes each submitted sequence as abstract-repr JSON,
    and on fetch decodes it, emulates it with ``TorchEmulator`` and
    samples each job's runs with :data:`TRI16_SEED`; the results cross
    back as abstract-repr JSON too."""
    import pulser_tpu_torch as P
    from pulser_tpu_torch.backend.remote import (
        BatchStatus,
        JobStatus,
        RemoteConnection,
        RemoteResults,
    )
    from pulser_tpu_torch.backend.results import Results
    from pulser_tpu_torch.devices import Device
    from pulser_tpu_torch.emulator import TorchEmulator

    class ChipConnection(RemoteConnection):
        def __init__(self):
            self.batches: dict[str, list[tuple[str, int]]] = {}
            self.sent: list[str] = []

        def submit(self, sequence, wait=False, open=False, batch_id=None,
                   **kwargs):
            payload = self._add_measurement_to_sequence(
                sequence
            ).to_abstract_repr()
            self.sent.append(payload)
            bid = batch_id or f"batch{len(self.batches)}"
            jobs = kwargs.get("job_params") or []
            self.batches.setdefault(bid, []).extend(
                (payload, job["runs"]) for job in jobs
            )
            return RemoteResults(bid, self)

        def _run_job(self, payload: str, runs: int):
            seq = P.Sequence.from_abstract_repr(payload)
            emu = TorchEmulator.from_sequence(
                seq, evaluation_times="Minimal", torch_device=torch_device
            )
            final = emu.run()
            np.random.seed(TRI16_SEED)
            counts = final.sample_final_state(runs)
            wire = Results.from_final_bitstrings(
                seq.register.qubit_ids, seq.get_duration(), counts
            ).to_abstract_repr()
            return Results.from_abstract_repr(wire)

        def _fetch_result(self, batch_id, job_ids):
            return tuple(
                self._run_job(payload, runs)
                for payload, runs in self.batches[batch_id]
            )

        def _query_job_progress(self, batch_id):
            return {
                f"job{i}": (JobStatus.PENDING, None)
                for i in range(len(self.batches[batch_id]))
            }

        def _get_batch_status(self, batch_id):
            return BatchStatus.PENDING

        def _get_job_ids(self, batch_id):
            return [f"job{i}" for i in range(len(self.batches[batch_id]))]

        def supports_open_batch(self):
            return False

        def fetch_available_devices(self):
            return {
                "AnalogDevice": Device.from_abstract_repr(
                    P.AnalogDevice.to_abstract_repr()
                )
            }

    return ChipConnection()


def _wire_tri16_path(K, S, card: str) -> dict:
    """TRI16 submitted as a QPU job: ``QPUBackend(seq, connection=...)
    .run(job_params=[{"runs": 500}])`` through :func:`chip_connection`,
    whose far end emulates it on the card: one K1 launch, and the counts
    equal to sampling the direct build's final state with the same
    seed."""
    import torch

    from pulser_tpu_torch import QPUBackend
    from pulser_tpu_torch.emulator import TorchEmulator

    seq = tri16_sequence()
    conn = chip_connection()
    torch.cuda.synchronize()
    _reset_launches(K)
    c_before = K.device_launches("ip_sesolve")
    t0 = time.perf_counter()
    remote = QPUBackend(seq, connection=conn).run(
        job_params=[{"runs": TRI16_RUNS}]
    )
    submit_s = time.perf_counter() - t0
    (result,) = remote.results
    counts = dict(result.final_bitstrings)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _launches(K)
    c_launches = K.device_launches("ip_sesolve") - c_before
    info = dict(S.last_solve_info)
    (payload,) = conn.sent
    _check_payload("WIRE_TRI16", payload)

    final = TorchEmulator.from_sequence(
        tri16_direct_sequence(), evaluation_times="Minimal"
    ).run()
    np.random.seed(TRI16_SEED)
    want = dict(final.sample_final_state(TRI16_RUNS))
    tv = _tv_distance(counts, want)
    print(
        f"WIRE_TRI16: QPUBackend.run() {submit_s * 1e3:.3f} ms (device check,"
        f" {len(payload)} bytes of JSON submitted, sha256 ok), results"
        f" {total_s * 1e3:.3f} ms in all; {info.get('kind')},"
        f" launches={launches} (device {c_launches}); {sum(counts.values())}"
        f" shots, {len(counts)} bitstrings, TV vs the direct build's final"
        f" state sampled with the same seed {tv:.4f} [{card}]",
        flush=True,
    )
    _check(info.get("kind") == "ip_sesolve_cuda", "WIRE_TRI16 takes K1")
    _check(launches["ip_sesolve"] == 1, "one K1 launch on WIRE_TRI16")
    _check(c_launches == 1, "one K1 device launch by the library's count")
    _check(sum(launches.values()) == 1, f"no other kernel: {launches}")
    _check(sum(counts.values()) == TRI16_RUNS, f"{TRI16_RUNS} shots")
    _check(counts == want, "WIRE_TRI16 counts equal the direct build's")
    return {
        "name": "WIRE_TRI16",
        "ms": total_s * 1e3,
        "submit_ms": submit_s * 1e3,
        "payload_bytes": len(payload),
        "launches": {"ip_sesolve": launches["ip_sesolve"]},
        "counts_tv": tv,
    }


#: The launches each served request must make, by kernel.
SERVE_KERNELS = {
    "SERVE_AFM16": "ip_sesolve",
    "SERVE_AFM16_ALL": "ip_sesolve",
    "SERVE_NOISY10": "mcwf_rows",
    "SERVE_TRI16": "ip_sesolve",
}


def serve_requests() -> dict:
    """The requests of the serving phase, as a client sends them:
    ``{name: (SolveClient method, keyword arguments)}``, every sequence
    and config already serialized. SERVE_AFM16 asks for AFM16's final
    state at its 101 evaluation times (SERVE_AFM16_ALL for all 101
    states), SERVE_NOISY10 for NOISY10's backend run with
    :func:`wire_noisy10_config` seeded with :data:`NOISY10_SEED`, and
    SERVE_TRI16 for :data:`TRI16_RUNS` shots of TRI16 seeded with
    :data:`TRI16_SEED`."""
    afm16 = afm16_sequence()
    afm16_run = dict(
        sequence=afm16.to_abstract_repr(),
        evaluation_times=np.linspace(
            0, afm16.get_duration() * 1e-3, 101
        ).tolist(),
    )
    noisy10, noise = noisy10_sequence()
    return {
        "SERVE_AFM16": ("run", dict(afm16_run, final_only=True)),
        "SERVE_AFM16_ALL": ("run", afm16_run),
        "SERVE_NOISY10": (
            "run_backend",
            dict(
                sequence=noisy10.to_abstract_repr(),
                config=wire_noisy10_config(noise).to_abstract_repr(),
                seed=NOISY10_SEED,
                deserialize=False,
            ),
        ),
        "SERVE_TRI16": (
            "run",
            dict(
                sequence=tri16_sequence().to_abstract_repr(),
                evaluation_times="Minimal",
                seed=TRI16_SEED,
                n_samples=TRI16_RUNS,
            ),
        ),
    }


def _serve_once(K, S, client, name: str, request: tuple) -> dict:
    """One request with the launch counters set to 0 just before it and
    read just after: its answer, wall seconds (client side, to the decoded
    answer), the daemon's phases, launches and route."""
    import torch

    from pulser_tpu_torch import profiling

    method, kwargs = request
    kernel = SERVE_KERNELS[name]
    torch.cuda.synchronize()
    profiling.reset_phases()
    _reset_launches(K)
    c_before = K.device_launches(kernel)
    t0 = time.perf_counter()
    answer = getattr(client, method)(**kwargs)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {
        "answer": answer,
        "wall_s": wall_s,
        "phases": profiling.phase_report(reset=True),
        "launches": _launches(K),
        "device_launches": K.device_launches(kernel) - c_before,
        "kind": S.last_solve_info.get("kind"),
    }


def _serve_timed(K, S, client, name: str, request: tuple, card: str,
                 repeats: int = 3) -> tuple[list, dict]:
    """``repeats`` warm requests; checks that each launched its kernel once
    (by the wrapper's and the C library's count) on the kernel route, and
    prints the wall time (median) split into the daemon's decode, solve
    and encode (medians), and the daemon's phase report of the requests.
    Returns the calls and the entry's timing keys."""
    calls = [_serve_once(K, S, client, name, request) for _ in range(repeats)]
    kernel = SERVE_KERNELS[name]
    for call in calls:
        _check(
            call["kind"] == f"{kernel}_cuda", f"{name} route {call['kind']}"
        )
        _check(
            call["launches"][kernel] == 1 and call["device_launches"] == 1,
            f"{name}: one {kernel} launch ({call['launches']}, device"
            f" {call['device_launches']})",
        )
        _check(
            sum(call["launches"].values()) == 1,
            f"{name}: no other kernel {call['launches']}",
        )

    def part(key: str) -> float:
        return statistics.median(
            c["phases"].get(key, {"total_s": 0.0})["total_s"] for c in calls
        ) * 1e3

    timing = {
        "ms": statistics.median(c["wall_s"] for c in calls) * 1e3,
        "decode_ms": part("serving.decode"),
        "solve_ms": part("serving.solve"),
        "encode_ms": part("serving.encode"),
    }
    how = f"median of {repeats}" if repeats > 1 else "one request"
    report: dict = {}
    for call in calls:
        for phase, v in call["phases"].items():
            r = report.setdefault(phase, {"total_ms": 0.0, "calls": 0})
            r["total_ms"] = round(r["total_ms"] + v["total_s"] * 1e3, 3)
            r["calls"] += int(v["calls"])
    print(
        f"{name}: warm request {timing['ms']:.3f} ms ({how}, to the decoded"
        f" answer): decode"
        f" {timing['decode_ms']:.3f}, solve {timing['solve_ms']:.3f},"
        f" encode {timing['encode_ms']:.3f} ms in the daemon (the rest: JSON,"
        f" socket, the client's decode); {calls[0]['kind']}, one {kernel} launch per"
        f" request (device {calls[0]['device_launches']}) [{card}]\n"
        f"  daemon phase_report over the {repeats} requests:"
        f" {json.dumps(report)}",
        flush=True,
    )
    return calls, timing


def _serve_afm16(K, S, client, requests: dict, card: str) -> list:
    """SERVE_AFM16 and SERVE_AFM16_ALL against the golden and the direct
    run of the same sequence."""
    from pulser_tpu_torch.emulator import TorchEmulator

    seq = afm16_sequence()
    direct = TorchEmulator.from_sequence(
        seq, evaluation_times=np.asarray(
            requests["SERVE_AFM16"][1]["evaluation_times"]
        )
    ).run()
    # Compared in complex128: the answers are complex64, and 1 - F in
    # float32 arithmetic would round to about 1e-7
    want = np.stack([s.full()[:, 0] for s in direct.states]).astype(
        np.complex128
    )
    golden = np.load(_GOLDEN)["final_state"]
    calls, timing = _serve_timed(
        K, S, client, "SERVE_AFM16", requests["SERVE_AFM16"], card
    )
    states = [c["answer"]["states"] for c in calls]
    _check(
        all(s.shape == (1, 1 << 16) and s.dtype == np.complex64
            for s in states),
        "SERVE_AFM16 answers one complex64 state",
    )
    _check(
        all(np.array_equal(s, states[0]) for s in states),
        "SERVE_AFM16 answers alike",
    )
    fin = states[0][0].astype(np.complex128)
    _check(bool(np.isfinite(fin).all()), "SERVE_AFM16 state finite")
    vs_golden = 1 - _fidelity(golden, fin)
    vs_direct = 1 - _fidelity(want[-1], fin)
    print(
        f"SERVE_AFM16: 1-F vs the golden {vs_golden:.3e}, vs the direct run"
        f" {vs_direct:.3e}",
        flush=True,
    )
    _check(vs_golden <= FIDELITY_TOL, f"SERVE_AFM16 vs golden {vs_golden}")
    _check(vs_direct <= WIRE_FIDELITY_TOL, f"vs direct {vs_direct}")

    (all_call,), all_timing = _serve_timed(
        K, S, client, "SERVE_AFM16_ALL", requests["SERVE_AFM16_ALL"], card,
        repeats=1,
    )
    wire_bytes = int(all_call["answer"]["states"].nbytes)
    got = all_call["answer"]["states"].astype(np.complex128)
    _check(got.shape == want.shape, f"SERVE_AFM16_ALL shape {got.shape}")
    worst = max(1 - _fidelity(w, g) for w, g in zip(want, got))
    print(
        f"SERVE_AFM16_ALL: {wire_bytes} bytes of states in one frame,"
        f" worst 1-F vs the direct run {worst:.3e}",
        flush=True,
    )
    _check(worst <= WIRE_FIDELITY_TOL, f"SERVE_AFM16_ALL 1-F {worst}")
    return [
        {
            "name": "SERVE_AFM16",
            **timing,
            "launches": {"ip_sesolve": calls[0]["launches"]["ip_sesolve"]},
            "one_minus_f_vs_golden": vs_golden,
            "one_minus_f_vs_direct": vs_direct,
        },
        {
            "name": "SERVE_AFM16_ALL",
            **all_timing,
            "state_bytes": wire_bytes,
            "launches": {
                "ip_sesolve": all_call["launches"]["ip_sesolve"]
            },
            "worst_one_minus_f_vs_direct": worst,
        },
    ]


def _serve_noisy10(K, S, client, requests: dict, card: str) -> dict:
    """SERVE_NOISY10 against the same backend run made directly."""
    from pulser_tpu_torch.backend.results import Results
    from pulser_tpu_torch.emulator import TorchBackendV2

    seq, noise = noisy10_sequence()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # samples_per_run
        np.random.seed(NOISY10_SEED)
        want = TorchBackendV2(seq, config=wire_noisy10_config(noise)).run()
    calls, timing = _serve_timed(
        K, S, client, "SERVE_NOISY10", requests["SERVE_NOISY10"], card
    )
    occ_err, tv = 0.0, 0.0
    for call in calls:
        res = Results.from_abstract_repr(call["answer"])
        occ_err = max(
            occ_err,
            *(
                float(
                    np.abs(
                        _as_numpy(res.get_result("occupation", t))
                        - _as_numpy(want.get_result("occupation", t))
                    ).max()
                )
                for t in (0.5, 1.0)
            ),
        )
        tv = max(tv, _tv_distance(res.final_bitstrings,
                                  want.final_bitstrings))
    print(
        f"SERVE_NOISY10: vs the direct backend run with the same seed:"
        f" occupations max|d| {occ_err:.3e}, counts TV {tv:.4f}; results"
        f" JSON {len(calls[0]['answer'])} bytes",
        flush=True,
    )
    _check(occ_err == 0.0, f"SERVE_NOISY10 occupations {occ_err:.3e}")
    _check(tv == 0.0, f"SERVE_NOISY10 counts TV {tv:.4f}")
    return {
        "name": "SERVE_NOISY10",
        **timing,
        "launches": {"mcwf_rows": calls[0]["launches"]["mcwf_rows"]},
        "occupation_max_abs_diff": occ_err,
        "counts_tv": tv,
    }


def _serve_tri16(K, S, client, requests: dict, card: str) -> dict:
    """SERVE_TRI16 against sampling the direct build's final state with
    the same seed (seeded before the emulator is built, as the daemon
    seeds)."""
    from pulser_tpu_torch.emulator import TorchEmulator

    np.random.seed(TRI16_SEED)
    want = dict(
        TorchEmulator.from_sequence(
            tri16_direct_sequence(), evaluation_times="Minimal"
        )
        .run()
        .sample_final_state(TRI16_RUNS)
    )
    calls, timing = _serve_timed(
        K, S, client, "SERVE_TRI16", requests["SERVE_TRI16"], card
    )
    counts = [c["answer"]["counts"] for c in calls]
    print(
        f"SERVE_TRI16: {sum(counts[0].values())} shots on {len(counts[0])}"
        f" bitstrings, equal to the direct build's"
        f" {all(c == want for c in counts)}",
        flush=True,
    )
    _check(all(c == want for c in counts), "SERVE_TRI16 counts equal")
    return {
        "name": "SERVE_TRI16",
        **timing,
        "launches": {"ip_sesolve": calls[0]["launches"]["ip_sesolve"]},
        "counts_tv": _tv_distance(counts[0], want),
    }


#: A fresh client: ``serving.py`` loaded by its path with ``torch`` and
#: ``jax`` blocked; sends the request in argv[3] to the daemon at argv[2]
#: and prints the final state's 1 − F against the golden in argv[4].
_FRESH_CLIENT = """
import importlib.util, json, sys
sys.modules["torch"] = None
sys.modules["jax"] = None
spec = importlib.util.spec_from_file_location("serving", sys.argv[1])
serving = importlib.util.module_from_spec(spec)
spec.loader.exec_module(serving)
import numpy as np
request = json.load(open(sys.argv[3]))
state = serving.SolveClient(sys.argv[2]).run(**request)["states"][-1]
state = state.astype(np.complex128)
golden = np.load(sys.argv[4])["final_state"]
f = abs(np.vdot(golden / np.linalg.norm(golden),
                state / np.linalg.norm(state))) ** 2
print(json.dumps({"one_minus_f": 1 - float(f), "modules": sorted(
    m for m in sys.modules if m.split(".")[0] in ("torch", "jax")
    and sys.modules[m] is not None)}))
"""

#: A fresh direct run: the package imported, the request in argv[1] run
#: with ``TorchEmulator`` on the card and the final state fetched.
_FRESH_DIRECT = """
import json, sys
import numpy as np
from pulser_tpu_torch import Sequence
from pulser_tpu_torch.emulator import TorchEmulator
request = json.load(open(sys.argv[1]))
seq = Sequence.from_abstract_repr(request["sequence"])
state = TorchEmulator.from_sequence(
    seq, evaluation_times=np.asarray(request["evaluation_times"])
).run().states[-1].full()[:, 0].astype(np.complex128)
golden = np.load(sys.argv[2])["final_state"]
f = abs(np.vdot(golden / np.linalg.norm(golden),
                state / np.linalg.norm(state))) ** 2
print(json.dumps({"one_minus_f": 1 - float(f)}))
"""


def _fresh_process(args: list, what: str) -> tuple[dict, float]:
    """Runs ``python -c ...`` from spawn to exit: its last line as JSON
    and the wall seconds; fails unless it exits with 0."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", *args],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=_ROOT,
        env=dict(os.environ, PYTHONPATH=_ROOT),
    )
    wall_s = time.perf_counter() - t0
    _check(
        out.returncode == 0,
        f"{what} exited {out.returncode}: {out.stderr[-2000:]}",
    )
    return json.loads(out.stdout.strip().splitlines()[-1]), wall_s


def _fresh_processes(socket_path: str, request: dict, tmp: str,
                     card: str) -> list:
    """(a) a fresh thin client against the warm daemon, (b) a fresh
    process that runs the same request itself; both from spawn to exit."""
    request_path = os.path.join(tmp, "serve_afm16.json")
    with open(request_path, "w") as f:
        json.dump(request, f)
    serving_py = os.path.join(_ROOT, "pulser_tpu_torch", "serving.py")
    client, client_s = _fresh_process(
        [_FRESH_CLIENT, serving_py, socket_path, request_path, _GOLDEN],
        "the fresh client",
    )
    direct, direct_s = _fresh_process(
        [_FRESH_DIRECT, request_path, _GOLDEN], "the fresh direct run"
    )
    print(
        f"fresh processes, spawn to exit: (a) a thin client (serving.py by"
        f" path, torch and jax blocked) answered by the warm daemon"
        f" {client_s * 1e3:.3f} ms, 1-F vs the golden"
        f" {client['one_minus_f']:.3e}; (b) import pulser_tpu_torch and"
        f" run TorchEmulator on the card {direct_s * 1e3:.3f} ms, 1-F"
        f" {direct['one_minus_f']:.3e} [{card}]",
        flush=True,
    )
    _check(client["modules"] == [], f"the thin client loaded {client}")
    _check(client["one_minus_f"] <= FIDELITY_TOL, "fresh client 1-F")
    _check(direct["one_minus_f"] <= FIDELITY_TOL, "fresh direct 1-F")
    return [
        {"name": "FRESH_CLIENT", "ms": client_s * 1e3,
         "one_minus_f_vs_golden": client["one_minus_f"]},
        {"name": "FRESH_DIRECT", "ms": direct_s * 1e3,
         "one_minus_f_vs_golden": direct["one_minus_f"]},
    ]


def _module_entry(socket_path: str, request: tuple, want: np.ndarray,
                  card: str) -> dict:
    """``SolveClient.ensure_server()`` spawns ``python -m
    pulser_tpu_torch.serving`` on the card: the time to its first ping,
    its first (cold) and second (warm) SERVE_AFM16 answers, equal to the
    in-process daemon's; then ``shutdown()``, and the child exits 0."""
    from pulser_tpu_torch import serving

    client = serving.SolveClient(socket_path)
    method, kwargs = request
    env = dict(os.environ, PYTHONPATH=_ROOT)
    try:
        t0 = time.perf_counter()
        up = client.ensure_server(spawn_timeout=300, env=env)
        ping_s = time.perf_counter() - t0
        _check(up, "the spawned daemon answers a ping")
        answers, times = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            answers.append(getattr(client, method)(**kwargs)["states"])
            times.append(time.perf_counter() - t0)
    finally:
        client.shutdown()
        if client.process is not None:
            try:
                code = client.process.wait(timeout=60)
            except subprocess.TimeoutExpired:
                client.process.kill()
                code = client.process.wait()
    print(
        f"python -m pulser_tpu_torch.serving: first ping"
        f" {ping_s * 1e3:.3f} ms after the spawn, first (cold) SERVE_AFM16"
        f" {times[0] * 1e3:.3f} ms, second (warm) {times[1] * 1e3:.3f} ms;"
        f" exit code {code} [{card}]",
        flush=True,
    )
    _check(
        all(np.array_equal(a, want) for a in answers),
        "the spawned daemon answers as the in-process one",
    )
    _check(code == 0, f"the spawned daemon exits {code}")
    return {
        "name": "SERVE_MODULE",
        "first_ping_ms": ping_s * 1e3,
        "cold_ms": times[0] * 1e3,
        "ms": times[1] * 1e3,
        "exit_code": code,
    }


def _serving_phase(K, S, card: str) -> list:
    """The resident daemon on the card: started in this process with
    SERVE_AFM16 as its warm request, it answers SERVE_AFM16 (and all 101
    states), SERVE_NOISY10 and SERVE_TRI16 through the port's
    ``SolveClient``; then two fresh processes and the module entry."""
    import tempfile
    import threading

    from pulser_tpu_torch import serving

    requests = serve_requests()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    path = os.path.join(tmp, "daemon.sock")
    ready = threading.Event()
    failed: list = []

    def daemon() -> None:
        try:
            serving.serve(
                path,
                device="cuda",
                ready_event=ready,
                warm_request=dict(requests["SERVE_AFM16"][1],
                                  kind="run_sequence"),
            )
        except Exception as err:  # noqa: BLE001 — reported below
            failed.append(err)
            ready.set()

    t0 = time.perf_counter()
    thread = threading.Thread(target=daemon, daemon=True)
    thread.start()
    _check(ready.wait(300) and not failed, f"the daemon is up: {failed}")
    up_s = time.perf_counter() - t0
    print(
        f"serving: in-process daemon on the card, up and warm (one AFM16"
        f" request) in {up_s * 1e3:.3f} ms [{card}]",
        flush=True,
    )
    client = serving.SolveClient(path)
    try:
        entries = _serve_afm16(K, S, client, requests, card)
        entries.append(_serve_noisy10(K, S, client, requests, card))
        entries.append(_serve_tri16(K, S, client, requests, card))
        want = client.run(**requests["SERVE_AFM16"][1])["states"]
        entries += _fresh_processes(path, requests["SERVE_AFM16"][1], tmp,
                                    card)
    finally:
        client.shutdown()
        thread.join(timeout=60)
    _check(not thread.is_alive() and not failed, "the daemon stopped")
    entries.append(
        _module_entry(
            os.path.join(tmp, "spawned.sock"), requests["SERVE_AFM16"],
            want, card,
        )
    )
    entries[0]["daemon_up_ms"] = up_s * 1e3
    return entries


#: The JAX package's run of NOISY10 with its trajectories sharded over a
#: mesh of two devices, seed 1234 (its quantum-jump scan, then the
#: measurement draws on the host in bitstring order; single precision on
#: a CPU), printed by ``JAX_PLATFORMS=cpu PYTHONPATH=. python
#: tools/shard_noisy10_reference.py``: the populations of
#: :data:`NOISY10_REFERENCE` to 1e-7, and the counts of that route. The
#: row-batched kernel draws in state order instead, so its counts are
#: another sample of the same distribution (TV 0.155 between the two).
SHARD_NOISY10_REFERENCE = {
    "seed": 1234,
    "n_steps": 501,
    "rydberg_populations": [
        0.464656344972354,
        0.2982658230709378,
        0.375744515138521,
        0.305061540958549,
        0.44385191374330296,
        0.45848762182598546,
        0.2903524365644879,
        0.383933457549652,
        0.2867388963919257,
        0.47287673687374865,
    ],
    "final_counts": {
        "0000010001": 3,
        "0000010010": 1,
        "0000010100": 2,
        "0000010101": 21,
        "0000100010": 1,
        "0000100100": 2,
        "0000101000": 2,
        "0000101010": 1,
        "0000110000": 7,
        "0000110010": 14,
        "0000110100": 11,
        "0000110101": 1,
        "0000110110": 1,
        "0000111010": 1,
        "0001000001": 1,
        "0001000101": 7,
        "0001001001": 2,
        "0001010000": 1,
        "0001010001": 5,
        "0001010100": 5,
        "0001010101": 60,
        "0001011001": 1,
        "0001110000": 1,
        "0001110100": 1,
        "0001110101": 1,
        "0010000001": 2,
        "0010000010": 1,
        "0010001000": 1,
        "0010001001": 4,
        "0010001010": 1,
        "0010010000": 5,
        "0010010001": 8,
        "0010010010": 6,
        "0010100000": 1,
        "0010100010": 3,
        "0010101000": 2,
        "0010101010": 9,
        "0010110000": 14,
        "0010110010": 29,
        "0010110100": 1,
        "0010111010": 2,
        "0100000001": 3,
        "0100000101": 4,
        "0100010000": 2,
        "0100010001": 9,
        "0100010010": 4,
        "0100010100": 2,
        "0100010101": 38,
        "0100010111": 1,
        "0100100010": 6,
        "0100100100": 5,
        "0100101100": 1,
        "0100110000": 7,
        "0100110010": 28,
        "0100110100": 41,
        "0100110110": 1,
        "0100111010": 1,
        "0101000001": 7,
        "0101000100": 3,
        "0101000101": 9,
        "0101010000": 6,
        "0101010001": 44,
        "0101010100": 9,
        "0101010101": 72,
        "0101010110": 1,
        "0101010111": 1,
        "0101011001": 1,
        "0101110101": 1,
        "0110010001": 1,
        "0110110000": 1,
        "0110110010": 1,
        "0111010101": 2,
        "1000000001": 1,
        "1000000010": 1,
        "1000000100": 1,
        "1000000101": 20,
        "1000001000": 1,
        "1000001001": 10,
        "1000001010": 3,
        "1000010100": 1,
        "1000010101": 1,
        "1000011010": 1,
        "1000100000": 3,
        "1000100010": 5,
        "1000100100": 9,
        "1000101000": 5,
        "1000101010": 28,
        "1000110000": 1,
        "1001000000": 1,
        "1001000001": 11,
        "1001000100": 3,
        "1001000101": 35,
        "1001001000": 5,
        "1001001001": 36,
        "1001001111": 1,
        "1001010101": 1,
        "1001100000": 1,
        "1001100001": 1,
        "1001100100": 1,
        "1001100101": 1,
        "1010000000": 3,
        "1010000001": 19,
        "1010000010": 6,
        "1010001000": 5,
        "1010001001": 43,
        "1010001010": 18,
        "1010001101": 1,
        "1010100000": 26,
        "1010100010": 38,
        "1010100011": 1,
        "1010100110": 1,
        "1010101000": 35,
        "1010101001": 2,
        "1010101010": 49,
        "1010101011": 2,
        "1010101110": 1,
        "1011000001": 1,
        "1011001001": 1,
        "1011100000": 1,
        "1011100010": 3,
        "1011101000": 1,
        "1011101010": 1,
    },
}

#: The sharding phase's tolerances: SHARD_STATE24 against the unsharded
#: solve of the same sequence on the card (1 − F in complex128, and the
#: distributed demo's own norm check), its one-rank NCCL twin against the
#: direct run; SHARD_NOISY10, SHARD_DEPH10 and SHARD2D_SPD10 are held to
#: NOISY10's, DEPH10's and SPD10's own tolerances.
SHARD_STATE_FIDELITY_TOL = 1e-6
SHARD_TWIN_FIDELITY_TOL = 1e-12
SHARD_NORM_TOL = 1e-5
#: The atoms of SHARD_STATE24 and the distributed demo's threshold.
SHARD_STATE_ATOMS = 24
SHARD_STATE_MIN_QUBITS = 20


def shard_state_sequence(n_atoms: int = SHARD_STATE_ATOMS, P=None):
    """The sequence of ``examples_torch/distributed_statevector_demo.py``:
    ``n_atoms`` at 7 µm on a truncated ``rows × cols`` grid (4×6 for 24),
    ``ConstantPulse(52, 2π, 1, 0)`` on ``MockDevice``."""
    if P is None:
        import pulser_tpu_torch as P

    rows = int(np.floor(np.sqrt(n_atoms)))
    cols = -(-n_atoms // rows)
    coords = [(7.0 * c, 7.0 * r) for r in range(rows) for c in range(cols)]
    reg = P.Register.from_coordinates(coords[:n_atoms], prefix="q")
    seq = P.Sequence(reg, P.devices.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(52, 2 * np.pi, 1.0, 0.0), "ryd")
    return seq


def _foreign_modules() -> list:
    """The modules of JAX or of the JAX package this process has loaded."""
    return sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pulser_tpu")
    )


def _sent_since(profiling, before: dict, name: str) -> int:
    """The bytes counted under ``name`` since the counter report
    ``before``."""
    return profiling.counter_report().get(name, 0) - before.get(name, 0)


def _shard_rank(case: str, env: dict, n_atoms: int, device=None) -> dict:
    """One rank's run of a sharding case through ``TorchEmulator``, on the
    card unless ``device`` says otherwise: its route, wall ms, the bytes it
    exchanged in the loop and gathered at the end, the modules of JAX it
    loaded (none), and what the checks need (rank 0 returns the arrays,
    the others their checksum)."""
    import hashlib

    import torch
    import torch.distributed as dist

    from pulser_tpu_torch import profiling
    from pulser_tpu_torch.emulator import TorchEmulator
    from pulser_tpu_torch.ops import solver as S
    from pulser_tpu_torch.parallel import comm, mesh2d, state_sharding

    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    captured: dict = {}
    restore = []
    if case == "STATE_TWIN":
        # The one-rank mesh, explicitly (the default mesh needs two ranks)
        orig = state_sharding.default_state_mesh
        state_sharding.default_state_mesh = lambda n, axis_name="state": (
            comm.make_mesh((1,), (axis_name,))
        )
        restore.append(lambda: setattr(state_sharding, "default_state_mesh", orig))
    if case == "NOISY10":
        solve, record = _recording(S, "mcsolve_rk4_batched", captured)
        S.mcsolve_rk4_batched = record
        restore.append(lambda: setattr(S, "mcsolve_rk4_batched", solve))
    if case == "SPD10_2D":
        solve, record = _recording(mesh2d, "sesolve_ip_2d_sharded", captured)
        mesh2d.sesolve_ip_2d_sharded = record
        restore.append(
            lambda: setattr(mesh2d, "sesolve_ip_2d_sharded", solve)
        )
    try:
        kw = {"evaluation_times": "Minimal", "torch_device": device}
        if case in ("STATE24", "STATE_TWIN"):
            seq, noise, seed = shard_state_sequence(n_atoms), None, None
        elif case == "NOISY10":
            (seq, noise), seed = noisy10_sequence(), NOISY10_REFERENCE["seed"]
        elif case == "DEPH10":
            (seq, noise), seed = deph10_sequence(), None
        else:
            (seq, noise), seed = spd10_sequence(), 1234
        sent = profiling.counter_report()
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if seed is not None:
            np.random.seed(seed)
        emu = TorchEmulator.from_sequence(seq, noise_model=noise, **kw)
        res = emu.run()
        if case == "DEPH10":
            arrays = {"final": res.get_final_state().full()}
        elif case in ("STATE24", "STATE_TWIN"):
            out = res.get_final_state(ignore_global_phase=False).full()
            arrays = {"final": out[:, 0]}
        else:
            states = np.asarray(captured["out"])
            arrays = {"final_states": states[:, -1]}
        peak = None
        if device != "cpu":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for undo in restore:
            undo()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    info = dict(S.last_solve_info)
    counts = None
    if case in ("NOISY10", "SPD10_2D"):
        counts = dict(res[-1].bitstring_counts)
        _check_shots(res)
    digest = hashlib.sha256(
        b"".join(np.ascontiguousarray(a).tobytes() for a in arrays.values())
    ).hexdigest()
    return {
        "rank": dist.get_rank(),
        "backend": str(dist.get_backend()),
        "staged": comm.stages_through_host(None, emu._torch_device),
        "device": str(emu._torch_device),
        "info": info,
        "ms": wall_ms,
        "peak_bytes": peak,
        "exchanged": _sent_since(profiling, sent, comm.EXCHANGED_BYTES),
        "gathered": _sent_since(profiling, sent, comm.GATHERED_BYTES),
        "foreign": _foreign_modules(),
        "digest": digest,
        "counts": counts,
        "arrays": arrays if dist.get_rank() == 0 else None,
    }


def _shard_run(pool, case: str, env: dict, n_atoms: int, device=None) -> dict:
    """``case`` on every rank of ``pool``: the ranks must agree bit for
    bit and load nothing of JAX; rank 0's answer, with the per-stage
    bytes."""
    outs = pool.run(_shard_rank, case, env, n_atoms, device)
    for out in outs:
        _check(out["foreign"] == [], f"rank {out['rank']} loaded {out['foreign']}")
        _check(
            out["digest"] == outs[0]["digest"],
            f"{case}: rank {out['rank']} differs from rank 0",
        )
    out = outs[0]
    stages = 4 * out["info"]["n_steps"]
    out["stages"] = stages
    out["exchanged_per_stage"] = out["exchanged"] / stages
    out["world"] = len(outs)
    return out


def _bytes_or_not_measured(n) -> str:
    return "not measured" if n is None else f"{n} B"


def _shard_line(name: str, out: dict, check: str, card: str) -> dict:
    """Prints a case's line and returns its ``paths`` entry."""
    info = out["info"]
    print(
        f"{name}: {out['world']} rank(s), {out['backend']}"
        f"{' (host-staged)' if out['staged'] else ''} on {out['device']},"
        f" route {info.get('kind')} over {info.get('ranks')} rank(s),"
        f" {out['ms']:.3f} ms wall (cold run()), {out['stages']} RK4 stages,"
        f" {out['exchanged_per_stage']:.0f} B exchanged per RK4 stage per rank,"
        f" {out['gathered']} B gathered at the end, peak device memory"
        f" {_bytes_or_not_measured(out['peak_bytes'])} a rank; {check}"
        f" [{card}]",
        flush=True,
    )
    return {
        "name": name,
        "ranks": out["world"],
        "backend": out["backend"],
        "host_staged": out["staged"],
        "route": info.get("kind"),
        "ms": out["ms"],
        "stages": out["stages"],
        "exchanged_bytes_per_stage": out["exchanged_per_stage"],
        "gathered_bytes": out["gathered"],
        "peak_device_bytes": out["peak_bytes"],
    }


def _unsharded_state(n_atoms: int, device=None) -> tuple:
    """SHARD_STATE's unsharded reference, solved in this process: the
    final state in complex128 and the device memory the run took at its
    peak (None on the CPU)."""
    import torch

    from pulser_tpu_torch.emulator import TorchEmulator
    from pulser_tpu_torch.ops import solver as S

    emu = TorchEmulator.from_sequence(
        shard_state_sequence(n_atoms), evaluation_times="Minimal",
        torch_device=device,
    )
    peak = None
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    direct = emu.run().get_final_state(ignore_global_phase=False)
    direct = direct.full()[:, 0].astype(np.complex128)
    if device != "cpu":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
    direct_ms = (time.perf_counter() - t1) * 1e3
    print(
        f"SHARD_STATE{n_atoms} reference: unsharded"
        f" {dict(S.last_solve_info)} in {direct_ms:.3f} ms (cold run()),"
        f" peak device memory {_bytes_or_not_measured(peak)}",
        flush=True,
    )
    return direct, peak


def _state_case(
    pool, name: str, env: dict, n_atoms: int, device, direct, direct_peak,
    card: str,
) -> dict:
    """SHARD_STATE on every rank of ``pool``, held to the unsharded
    ``direct`` state: 1 − F, the norm, and on the card a peak device
    memory a rank below the unsharded run's (each rank's share of the
    result leaves the card before the ranks assemble it)."""
    out = _shard_run(pool, "STATE24", env, n_atoms, device)
    got = out["arrays"]["final"].astype(np.complex128)
    infid = 1 - _fidelity(direct, got)
    norm_err = abs(np.linalg.norm(got) - 1)
    _check(
        out["info"].get("kind") == "sesolve_state_sharded_torch"
        and out["info"].get("ranks") == out["world"],
        f"{name} route {out['info']}",
    )
    _check(infid <= SHARD_STATE_FIDELITY_TOL, f"{name} 1 - F {infid:.3e}")
    _check(norm_err <= SHARD_NORM_TOL, f"{name} norm {norm_err:.3e}")
    check = (
        f"1 - F = {infid:.3e} to the unsharded solve (≤"
        f" {SHARD_STATE_FIDELITY_TOL:g}), |norm - 1| = {norm_err:.3e} (≤"
        f" {SHARD_NORM_TOL:g})"
    )
    if direct_peak is not None:
        _check(
            out["peak_bytes"] < direct_peak,
            f"{name} peak {out['peak_bytes']} B a rank, unsharded"
            f" {direct_peak} B",
        )
        check += (
            f", peak device memory {out['peak_bytes'] / direct_peak:.3f}"
            " of the unsharded run's"
        )
    return _shard_line(name, out, check, card)


def _sharding_phase(card: str, device=None, n_atoms: int = SHARD_STATE_ATOMS):
    """Trajectory and state sharding on ranks spawned from this script
    (:class:`pulser_tpu_torch.parallel.RankPool`: a ``FileStore`` in a
    temporary directory, one torch thread per rank, every rank's tensors
    on the card): SHARD_STATE24 over 2 gloo ranks and its one-rank NCCL
    twin, SHARD_NOISY10 and SHARD_DEPH10 over 2 gloo ranks, SHARD2D_SPD10
    on a 2 × 2 gloo mesh. Gloo moves host buffers, so on the card its
    collectives are staged through host memory by
    ``pulser_tpu_torch.parallel.comm.host_staged_collective``. ``device``
    and ``n_atoms`` let the phase be rehearsed on the CPU at a small
    size."""
    import tempfile

    from pulser_tpu_torch.parallel import RankPool

    cpu = device == "cpu"
    print(
        "sharding phase: ranks spawned with torch.multiprocessing (spawn),"
        " FileStore rendezvous, 1 torch thread per rank; gloo collectives on"
        f" {'host' if cpu else 'CUDA'} tensors"
        + (
            ""
            if cpu
            else " staged through host memory by"
            " pulser_tpu_torch.parallel.comm.host_staged_collective"
        ),
        flush=True,
    )
    state_env = {
        "PULSER_TPU_STATE_SHARD_MIN_QUBITS": str(
            min(SHARD_STATE_MIN_QUBITS, n_atoms)
        )
    }
    entries = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pools = {
            "gloo2": RankPool(2, os.path.join(tmp, "g2"), "gloo"),
            "nccl1": None if cpu else RankPool(1, os.path.join(tmp, "n1"), "nccl"),
            "gloo4": RankPool(4, os.path.join(tmp, "g4"), "gloo"),
        }
        try:
            direct, direct_peak = _unsharded_state(n_atoms, device)
            entries.append(
                _state_case(
                    pools["gloo2"], f"SHARD_STATE{n_atoms}", state_env,
                    n_atoms, device, direct, direct_peak, card,
                )
            )
            if pools["nccl1"] is not None:
                out = _shard_run(
                    pools["nccl1"], "STATE_TWIN", state_env, n_atoms, device
                )
                got = out["arrays"]["final"].astype(np.complex128)
                infid = 1 - _fidelity(direct, got)
                _check(
                    out["info"].get("kind") == "sesolve_state_sharded_torch"
                    and "nccl" in out["backend"],
                    f"twin route {out['info']} on {out['backend']}",
                )
                _check(infid <= SHARD_TWIN_FIDELITY_TOL, f"twin 1 - F {infid:.3e}")
                entries.append(
                    _shard_line(
                        f"SHARD_STATE{n_atoms}_NCCL1", out,
                        f"1 - F = {infid:.3e} to the direct run (≤"
                        f" {SHARD_TWIN_FIDELITY_TOL:g})",
                        card,
                    )
                )

            out = _shard_run(pools["gloo2"], "NOISY10", {}, n_atoms, device)
            n_q = out["info"]["n"]
            probs = np.abs(out["arrays"]["final_states"].astype(np.complex128)) ** 2
            probs /= probs.sum(axis=1, keepdims=True)
            pops = _rydberg_populations(probs, n_q).mean(axis=0)
            pop_err = float(
                np.max(np.abs(pops - NOISY10_REFERENCE["rydberg_populations"]))
            )
            tv = _tv_distance(
                out["counts"], SHARD_NOISY10_REFERENCE["final_counts"]
            )
            tv_rows = _tv_distance(
                out["counts"], NOISY10_REFERENCE["final_counts"]
            )
            _check(
                out["info"].get("kind") == "mcwf_batched_torch"
                and out["info"].get("ranks") == 2
                and out["info"]["n_steps"] == NOISY10_REFERENCE["n_steps"],
                f"SHARD_NOISY10 route {out['info']}",
            )
            _check(pop_err <= POPULATION_TOL, f"populations {pop_err:.3e}")
            _check(tv <= COUNTS_TV_TOL, f"count TV {tv:.4f}")
            entries.append(
                _shard_line(
                    "SHARD_NOISY10", out,
                    f"vs the JAX package (seed {NOISY10_REFERENCE['seed']}):"
                    f" Rydberg populations max|d| = {pop_err:.3e} (≤"
                    f" {POPULATION_TOL:g}) to NOISY10's, final counts TV ="
                    f" {tv:.4f} (≤ {COUNTS_TV_TOL:g}) to its sharded route's"
                    f" (TV {tv_rows:.4f} to NOISY10's row-kernel draws, drawn"
                    " in state order)",
                    card,
                )
            )

            with open(_MESOLVE_GOLDENS["deph10"]) as f:
                ref = json.load(f)
            out = _shard_run(
                pools["gloo2"], "DEPH10",
                {"PULSER_TPU_RHO_SHARD_MIN_QUBITS": "10"}, n_atoms, device,
            )
            info = out["info"]
            _check(
                info.get("kind", "").startswith("mesolve_")
                and info.get("ranks") == 2
                and info["ip"] == ref["interaction_picture"]
                and info["n_steps"] == ref["n_steps"],
                f"SHARD_DEPH10 route {info}",
            )
            _rho_checks(out["arrays"]["final"], ref, "SHARD_DEPH10")
            entries.append(
                _shard_line(
                    "SHARD_DEPH10", out,
                    f"ρ rows 2 × {info['dim'] // 2}, checks as DEPH10's", card,
                )
            )

            with open(_SPD10_GOLDEN) as f:
                ref = json.load(f)
            out = _shard_run(
                pools["gloo4"], "SPD10_2D",
                {
                    "PULSER_TPU_TRAJ_STATE_MESH": "2x2",
                    "PULSER_TPU_STATE_SHARD_MIN_QUBITS": "10",
                },
                n_atoms, device,
            )
            tv = _tv_distance(out["counts"], ref["final_counts"])
            _check(
                out["info"].get("kind") == "sesolve_2d_sharded_torch"
                and tuple(out["info"].get("mesh", ())) == (2, 2),
                f"SHARD2D_SPD10 route {out['info']}",
            )
            _check(tv <= COUNTS_TV_TOL, f"count TV {tv:.4f}")
            entries.append(
                _shard_line(
                    "SHARD2D_SPD10", out,
                    f"vs the JAX package (seed {ref['seed']}): final counts TV"
                    f" = {tv:.4f} (≤ {COUNTS_TV_TOL:g}),"
                    f" {out['info']['n_traj'] // 2} trajectories per traj group",
                    card,
                )
            )
        finally:
            for pool in pools.values():
                if pool is not None:
                    pool.close()
        print(
            f"sharding phase: {time.perf_counter() - t0:.3f} s with the"
            " ranks' start-up",
            flush=True,
        )
    return entries


def _across_cards_phase(card: str) -> list:
    """SHARD_STATE24 over NCCL, one rank a card (``--across-cards``, on a
    host with several cards): over 2 ranks and over the largest
    power-of-two count of the visible cards, each held to this process's
    unsharded solve as in the sharding phase. NCCL moves device buffers,
    so the ranks' shares cross the card in pieces on their way to the
    host (``parallel.comm.gather_to_host``)."""
    import tempfile

    import torch

    from pulser_tpu_torch.parallel import RankPool

    n_cards = torch.cuda.device_count()
    _check(n_cards >= 2, f"--across-cards needs several cards, not {n_cards}")
    env = {"PULSER_TPU_STATE_SHARD_MIN_QUBITS": str(SHARD_STATE_MIN_QUBITS)}
    direct, direct_peak = _unsharded_state(SHARD_STATE_ATOMS)
    entries = []
    with tempfile.TemporaryDirectory() as tmp:
        for world in sorted({2, 1 << (n_cards.bit_length() - 1)}):
            with RankPool(world, os.path.join(tmp, f"n{world}"), "nccl") as pool:
                entries.append(
                    _state_case(
                        pool, f"SHARD_STATE{SHARD_STATE_ATOMS}_NCCL{world}",
                        env, SHARD_STATE_ATOMS, None, direct, direct_peak,
                        card,
                    )
                )
    return entries


#: The JAX package's values of the six tutorials (``docs/tutorials/src``,
#: each after ``np.random.seed`` of the file's ``seed``, single precision,
#: the quantum-jump batch on the row-batched kernel interpreted on a
#: CPU), written by ``JAX_PLATFORMS=cpu PYTHONPATH=. python
#: tools/tutorial_references.py``: for each key of
#: ``tools/build_tutorials_torch.py::KEY_VALUES``, its kind and value
#: (TUT01's final state alone has 512 amplitudes, so they are a golden
#: file, not literals).
_TUTORIALS_GOLDEN = os.path.join(
    _ROOT, "tests", "goldens", "tutorials_reference.json"
)
#: PERF.md §2's limits, by kind of key value (``exact``: equal).
TUTORIAL_TOL = {
    "state": FIDELITY_TOL,
    "rho": RHO_TOL,
    "populations": POPULATION_TOL,
    "counts": COUNTS_TV_TOL,
    "exact": 0.0,
}


def _tutorial_line(name: str, wall_s: float, cells: int, counts: dict,
                   checks: dict, card: str) -> dict:
    shown = ", ".join(
        f"{key} {kind} {err:.3e}" for key, (kind, err) in checks.items()
    )
    print(
        f"{name}: {cells} code cells, every assert held, {wall_s:.3f} s wall,"
        f" kernel launches {counts}; against the JAX tutorial: {shown}"
        f" [{card}]",
        flush=True,
    )
    return {
        "name": name,
        "ms": wall_s * 1e3,
        "launches": counts,
        "checks": {key: err for key, (_, err) in checks.items()},
    }


def _tutorials_phase(K, S, card: str) -> tuple[list, int]:
    """The six tutorials of ``docs/tutorials_torch`` on the card, through
    ``tools/build_tutorials_torch.py`` with ``DEVICE = "cuda"`` into a
    temporary directory (this host has no matplotlib: the cells draw on
    ``build_tutorials_torch``'s inert stand-in, every assert runs). Each
    tutorial starts from the golden's numpy seed; its key values are held
    to the JAX package's (:data:`TUTORIAL_TOL`, and |tr ρ − 1| ≤
    TRACE_TOL). TUT02's quantum-jump cell (``nm_both``: dephasing with amplitude and
    Doppler noise, 60 trajectories of 4 atoms) must take K2 in exactly
    one launch, by the wrapper's count and the C library's. Returns the
    ``paths`` entries and that cell's K2 launches."""
    import tempfile

    import torch

    from tools import build_tutorials_torch as B

    with open(_TUTORIALS_GOLDEN) as f:
        golden = json.load(f)
    entries, k2_launches = [], None
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for index, name in enumerate(B.names(), start=1):
            cells = []

            def on_cell(_, code, seconds, cells=cells):
                torch.cuda.synchronize()
                cells.append(
                    (
                        code,
                        _launches(K),
                        {k: K.device_launches(k) for k in K.SOURCES},
                        dict(S.last_solve_info),
                    )
                )

            _reset_launches(K)
            lib0 = {k: K.device_launches(k) for k in K.SOURCES}
            np.random.seed(golden["seed"])
            t0 = time.perf_counter()
            ns = B.execute(name, "cuda", tmp, on_cell)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            _check(
                os.path.exists(os.path.join(tmp, f"{name}.md")),
                f"{name} wrote no page",
            )
            want = B.decode(golden["tutorials"][name])
            got = B.KEY_VALUES[name](ns)
            checks = {}
            for key, (kind, value) in want.items():
                err = B.difference(kind, value, got[key][1])
                checks[key] = (kind, err)
                _check(
                    err <= TUTORIAL_TOL[kind],
                    f"{name} {key}: {kind} {err:.3e} > {TUTORIAL_TOL[kind]}",
                )
                if kind == "rho":
                    tr_err = abs(np.trace(got[key][1]).real - 1)
                    checks[f"{key}_trace"] = ("trace", tr_err)
                    _check(tr_err <= TRACE_TOL, f"{name} trace {tr_err:.3e}")
            label = f"TUT{index:02d}"
            if name == "02_noisy_simulation":
                prev_w, prev_l = dict.fromkeys(K.SOURCES, 0), lib0
                for code, wrapper, lib, info in cells:
                    if "nm_both = ptt.NoiseModel(" in code:
                        k2 = wrapper["mcwf_rows"] - prev_w["mcwf_rows"]
                        k2_lib = lib["mcwf_rows"] - prev_l["mcwf_rows"]
                        _check(
                            k2 == 1 and k2_lib == 1
                            and info.get("kind") == "mcwf_rows_cuda",
                            f"TUT02 nm_both: {k2} K2 launches by the wrapper,"
                            f" {k2_lib} by the library, route {info}",
                        )
                        k2_launches = k2
                        print(
                            f"TUT02 nm_both: one K2 launch (wrapper and"
                            f" library), route {info}",
                            flush=True,
                        )
                    prev_w, prev_l = wrapper, lib
                _check(k2_launches == 1, "TUT02 has no nm_both cell")
            entries.append(
                _tutorial_line(label, wall_s, len(cells), _launches(K),
                               checks, card)
            )
    print(
        f"tutorials phase: {time.perf_counter() - t_phase:.3f} s [{card}]",
        flush=True,
    )
    return entries, k2_launches


#: The ladder's sizes on one card (the JAX ladder's).
SCALE_SIZES = (24, 25, 26)


def _complex128_state(seq, device) -> "torch.Tensor":
    """The final state of ``seq`` solved in complex128 on ``device``
    (the torch default dtype set to float64 for the run)."""
    import torch

    from pulser_tpu_torch.emulator import TorchEmulator

    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        emu = TorchEmulator.from_sequence(
            seq, evaluation_times="Minimal", torch_device=device
        )
        batch = emu.run()._device_states
        state = batch.device_state(len(batch) - 1)
        _check(state.dtype == torch.complex128, f"reference dtype {state.dtype}")
        return state
    finally:
        torch.set_default_dtype(prev)


def _scale_line(name: str, rec: dict, check: str, card: str) -> dict:
    print(
        f"{name}: {rec['n_atoms']} atoms, route {rec['solver_kind']}, build"
        f" {rec['build_s'] * 1e3:.3f} ms, cold run() {rec['cold_solve_s'] * 1e3:.3f}"
        f" ms, warm {[round(t * 1e3, 3) for t in rec['warm_solve_s']]} ms,"
        f" {rec['stages']} RK4 stages, {rec['ms_per_stage']:.4f} ms a stage,"
        f" peak device memory {rec['peak_bytes']} B against solve_bytes"
        f" {rec['solve_bytes']} B ({rec['peak_bytes'] / rec['solve_bytes']:.3f}),"
        f" {rec['telemetry']}; {check} [{card}]",
        flush=True,
    )
    return {
        "name": name,
        "atoms": rec["n_atoms"],
        "route": rec["solver_kind"],
        "ms": rec["warm_median_s"] * 1e3,
        "cold_ms": rec["cold_solve_s"] * 1e3,
        "stages": rec["stages"],
        "ms_per_stage": rec["ms_per_stage"],
        "peak_device_bytes": rec["peak_bytes"],
        "solve_bytes": rec["solve_bytes"],
    }


def _scale_phase(card: str) -> list:
    """The scale ladder on the card (``tools/scale_ladder_torch.py``'s
    ``run_size``): SCALE24, SCALE25 and SCALE26, each with build, cold
    and warm (median of 3) solves, |norm − 1| ≤ 1e-4, a peak device
    memory at most the capacity contract's ``solve_bytes`` and 1 − F ≤
    1e-6 against a complex128 solve of the same sequence on the card;
    then SCALE_CEIL, one cold solve at ``single_chip_ceiling(2,
    measured_memory_bytes())`` qubits, with the norm and memory checks."""
    import torch

    from tools import scale_ladder_torch as L

    entries = []
    t_phase = time.perf_counter()
    for n in SCALE_SIZES:
        gc.collect()
        torch.cuda.empty_cache()
        rec = L.run_size(n, "cuda")
        got = rec.pop("state").to(torch.complex128)
        ref = _complex128_state(L.ladder_sequence(n), "cuda")
        infid = 1 - float(
            abs(torch.vdot(ref, got)) ** 2
            / (torch.vdot(ref, ref).real * torch.vdot(got, got).real)
        )
        del got, ref
        _check(
            rec["peak_bytes"] <= rec["solve_bytes"],
            f"SCALE{n} peak {rec['peak_bytes']} B > solve_bytes"
            f" {rec['solve_bytes']} B",
        )
        _check(infid <= FIDELITY_TOL, f"SCALE{n} 1 - F {infid:.3e}")
        entries.append(
            _scale_line(
                f"SCALE{n}", rec,
                f"|norm - 1| = {abs(rec['norm'] - 1):.3e} (≤ {L.NORM_TOL:g}),"
                f" 1 - F = {infid:.3e} to the complex128 solve (≤"
                f" {FIDELITY_TOL:g})",
                card,
            )
        )
    gc.collect()
    torch.cuda.empty_cache()
    n = L.ceiling_size()
    rec = L.run_size(n, "cuda", warm_runs=0)
    del rec["state"]
    _check(
        rec["peak_bytes"] <= rec["solve_bytes"],
        f"SCALE_CEIL peak {rec['peak_bytes']} B > solve_bytes"
        f" {rec['solve_bytes']} B",
    )
    entries.append(
        _scale_line(
            "SCALE_CEIL", rec,
            f"the ceiling single_chip_ceiling(2, {torch.cuda.mem_get_info()[1]}"
            f" B) = {n} qubits, |norm - 1| = {abs(rec['norm'] - 1):.3e}",
            card,
        )
    )
    gc.collect()
    torch.cuda.empty_cache()
    print(
        f"scale phase: {time.perf_counter() - t_phase:.3f} s [{card}]",
        flush=True,
    )
    return entries


def _validator_line() -> None:
    """Names the JSON-schema validator this host has: the loads of the
    wire paths validate every payload with it."""
    import importlib

    for name in ("fastjsonschema", "jsonschema"):
        try:
            importlib.import_module(name)
        except ImportError:
            continue
        from importlib.metadata import version

        print(f"schema validator: {name} {version(name)}", flush=True)
        return
    print("schema validator: none on this host", flush=True)


def main() -> int:
    import torch

    # 1. The card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pulser_tpu_torch.ops.kernels as K
    from pulser_tpu_torch.ops import solver as S

    card = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(
        "torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0], flush=True,
    )
    device = torch.device("cuda")
    if sys.argv[1:] == ["--across-cards"]:
        report = {"paths": _across_cards_phase(card)}
    else:
        report = _main_path(K, S, device, card)
    print(json.dumps(report))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


def _main_path(K, S, device, card: str) -> dict:
    """Every phase of the script on one card: the report line's object."""
    _validator_line()

    _build(K)  # 2
    _random_inputs_phase(K, device)  # 3-5
    report = {
        "kernels": [
            _afm16_path(K, S, device, card),  # 6
            _tri16_path(K, S, device, card),  # 21
            _spd_path(
                K, S, device, card, "SPD10", spd10_sequence, _SPD10_GOLDEN
            ),  # 11-12
            _noisy10_path(K, S, device, card),  # 7-8
            _regnoise10_path(K, S, device, card),  # 22
            _pauli10_path(K, S, device, card),  # 9-10
            _spd_path(
                K, S, device, card, "SPD16", spd16_sequence, _SPD16_GOLDEN
            ),  # 32
            _sampler_path(K, S, device, card),  # 33
        ],
        "paths": [
            _backend_afm16_path(K, S, card),  # 19
            _backend_noisy10_path(K, S, card),  # 20
            _single_rho_path(S, "DEPH10", deph10_sequence, card),  # 13
            _mesolve10_path(S, card),  # 14
            _single_rho_path(S, "EFF8", eff8_sequence, card),  # 15
            _xy16_path(S, card),  # 16
            _relax10_path(K, S, card),  # 17
            _mcdepol10_path(S, card),  # 18
            _wire_afm16_path(K, S, card),  # 23
            _wire_noisy10_path(K, S, card),  # 24
            _wire_tri16_path(K, S, card),  # 25
        ],
    }
    tutorials, tut02_k2 = _tutorials_phase(K, S, card)  # 30
    report["paths"] += tutorials
    report["paths"] += _scale_phase(card)  # 31
    serve = _serving_phase(K, S, card)  # 26-28
    report["paths"] += serve
    report["paths"] += _sharding_phase(card)  # 29
    launches = {e["name"]: e["launches"] for e in serve if "launches" in e}
    k1, k2 = report["kernels"][0], report["kernels"][3]
    k1b, spd16 = report["kernels"][2], report["kernels"][-2]
    k1b["also_on"] = {"SPD16": spd16["launches"]}
    k1["also_on"] = {
        name: launches[name]["ip_sesolve"]
        for name in ("SERVE_AFM16", "SERVE_TRI16")
    }
    k2["also_on"] = {
        "SERVE_NOISY10": launches["SERVE_NOISY10"]["mcwf_rows"],
        "TUT02": tut02_k2,
    }
    return report


if __name__ == "__main__":
    sys.exit(main())
