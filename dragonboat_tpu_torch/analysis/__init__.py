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
- ``contracts``    — ``CONTRACTS`` and ``DONATION`` against the tensors
  and the compiled entries the port builds (KC007, KC008);
- ``transfer``     — the declared device<->host seam, and a guarded step
  loop whose live crossings are diffed against the ledger (on the card
  the guard is ``torch.cuda.set_sync_debug_mode("error")``);
- ``partition``    — the dynamic leg only (PS002's cross-check): one serve
  step of a split mesh (``parallel/ici.py``), and every ``part=G`` leaf
  of each position on that position's device with its ``n_local`` rows.
  The static walk (PS001 cross-G reductions, PS003 replicated operands
  mixed with split ones, PS006 implicit syncs in the engine's hot paths)
  is not ported yet (ROADMAP.md).

What has no torch form, and is not invented here:

- ``hlo_budget`` counts XLA HLO gather/scatter/while ops of the lowered
  step; the port's step is eager PyTorch captured into CUDA graphs, with
  no HLO to count;
- ``partition``'s PS002 static leg checks ``shard_map`` in/out specs;
  the port's split mesh has no ``shard_map`` (its positions' pieces are
  checked as they are, above), and PS004's donor/result shardings are
  the pieces' own devices;
- ``tracer_safety`` finds Python control flow on JAX tracers inside
  jitted scope; torch has no tracers (the contracts pass's abstract
  interpreter, KC001-KC006, rides on that walk and is left out with it);
- ``hostenv``'s JAX compile cache: CUDA graphs are captured anew in each
  process, and ``ExpertConfig.compile_cache`` stays refused.

Each pass exposes ``run(root, files=None, ...)`` returning
``list[common.Finding]`` so tests can point it at fixtures.
"""
