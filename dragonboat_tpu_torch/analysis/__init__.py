"""The port's static and dynamic analysis passes
(``python -m dragonboat_tpu_torch.analysis``, ``__main__.py``).

Ported from the reference's ``analysis/`` package, each pass scoped to the
port's own files:

- ``common``       — findings, waivers and the contract / invariant
  grammars (a verbatim copy of the reference's module);
- ``concurrency``  — ``# guarded-by:`` discipline and the CC003 lock-order
  graph, over the reference's thread-shared modules plus the port's
  ``graphs.py`` and ``engine/``;
- ``determinism``  — no wall clock, unseeded RNG or set-order dependence
  in the replay paths;
- ``safety``       — the ``INVARIANTS`` declarations, the kernel's store
  obligations (RS002-RS004, which own the seeded ``commit_without_quorum``,
  ``skip_vote_persist`` and ``truncate_committed``) and the model
  checker's fast scope on a device (RS005);
- ``engine_unity`` — one step loop, one dispatch abstraction;
- ``contracts``    — the abstract interpreter over ``core/kernel.py``
  (KC001-KC006: named-axis broadcasts, silent dtype conversions in torch
  spelling, bool/i32 comparisons, unmasked ring indices, out-of-domain
  and mis-shaped stores), ``CONTRACTS`` and ``DONATION`` against the
  tensors and the compiled entries the port builds (KC007, KC008);
- ``transfer``     — the declared device<->host seam, and a guarded step
  loop whose live crossings are diffed against the ledger (on the card
  the guard is ``torch.cuda.set_sync_debug_mode("error")``);
- ``partition``    — the static walk (PS001 cross-G reductions, with G
  written out in ``core/kernel.py`` and ``rsm/device_kv.py`` too; PS003
  replicated values mixed with split ones; PS006 implicit syncs in hot
  host paths, deferring to TB005 over the engine files) and the dynamic
  leg (PS002's cross-check): one serve step of a split mesh
  (``parallel/ici.py``), and every ``part=G`` leaf of each position on
  that position's device with its ``n_local`` rows;
- ``tracer_safety`` — host control flow, host reads, syncs and frozen
  host effects (TS001-TS004) in the scope a CUDA graph captures: every
  function reachable from a ``graphs.compiled`` entry;
- ``op_budget``    — the counterpart of the reference's ``hlo_budget``:
  the aten ops one call of ``bench_loop._run_body`` and one split serve
  step dispatch on the CPU (each hand kernel's wrapper call one op),
  gated by class (gather, scatter, sync, total) against
  ``analysis/op_budget.json``.

What has no torch form, and is not invented here:

- ``hostenv``'s JAX compile cache: CUDA graphs are captured anew in each
  process, and ``ExpertConfig.compile_cache`` stays refused;
- ``partition``'s PS002 static leg checks ``shard_map`` in/out specs;
  the port's split mesh has no ``shard_map`` (its positions' pieces are
  checked as they are, by the dynamic leg);
- PS004's donor/result shardings are the pieces' own devices: a donated
  buffer never changes device;
- PS005 finds host callbacks in ``shard_map`` bodies; a position's body
  is a captured entry here, where a host round-trip is TS002/TS003.

Each pass exposes ``run(root, files=None, ...)`` returning
``list[common.Finding]`` so tests can point it at fixtures.
"""
