"""The exactness argument of K3's design (``csrc/kv_apply.cu``), on the CPU.

The kernel cannot run here, so this file checks its algorithm: a small
torch model of the kernel's rule — speculate every command against the
table as it stood, verify each row, run the commands in order on a
shared-memory image of the probe windows for the rows that fail, write
back each written slot from its last writer — against the sequential
plain arm ``DeviceKV.apply_kernel``, bit for bit, over random small
geometries, and on three seeds against the JAX reference.

The verify is modelled both as the pairwise rule (no earlier write slot in
a later active command's window) and as the kernel's stamp rule (each
writer stamps its index on its slot; racing stamps leave any one writer,
modelled here as the first and as the last); all three must agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonboat_tpu.rsm.device_kv import DeviceKV as RefKV
from dragonboat_tpu_torch import convert
from dragonboat_tpu_torch.rsm.device_kv import DeviceKV
from dragonboat_tpu_torch.rsm.device_kv_kernels import apply_window

I32 = torch.int32
INT_MAX = 2**31 - 1


def _stamp_fail(w, do, active, win, T, reduce):
    """The kernel's verify: each writer's index stamped on its slot (the
    racing writers of one slot leave ``reduce`` of their indexes); a row
    fails where a writer reads back another index or an active command
    finds a smaller index in its window."""
    G, AB = w.shape
    idx = torch.arange(AB, dtype=torch.int64).expand(G, AB)
    stamp = torch.full((G, T + 1), INT_MAX, dtype=torch.int64)
    col = torch.where(do, w, T).long()           # column T: no write
    stamp.scatter_reduce_(1, col, torch.where(do, idx, INT_MAX), reduce,
                          include_self=False)
    shared = do & (torch.gather(stamp, 1, col) != idx)
    earlier = active & (torch.gather(stamp, 1, win.reshape(G, -1).long())
                        .reshape(win.shape) < idx[..., None]).any(-1)
    return (shared | earlier).any(1)


def model_apply(kv: DeviceKV, state: dict, cmds: torch.Tensor,
                valid: torch.Tensor):
    """The kernel's rule in torch; returns (state, (results, ok), serial)
    with ``serial [G]`` True for the rows that ran in order."""
    keys, vals, count = (state[f].clone() for f in ("keys", "vals", "count"))
    G, T = keys.shape
    AB, D = cmds.shape[1], kv.probe_depth
    key, val = cmds[..., 0], cmds[..., 1]
    stored = key + 1
    active = valid & (key >= 0)
    home = kv.home_slot(key.reshape(-1)).reshape(G, AB)
    win = (home[..., None] + torch.arange(D, dtype=I32)) & (T - 1)  # [G, AB, D]

    # speculate: every command against the table as it stood
    pk = torch.gather(keys, 1, win.reshape(G, -1).long()).reshape(G, AB, D)
    hit, empty = pk == stored[..., None], pk == 0
    any_hit = hit.any(-1)
    pick = torch.where(any_hit, torch.argmax(hit.to(I32), -1),
                       torch.argmax(empty.to(I32), -1))
    do = active & (hit | empty).any(-1)
    w = torch.where(do, torch.gather(win, 2, pick[..., None])[..., 0], -1)
    fresh = do & ~any_hit

    # verify
    j = torch.arange(AB)
    in_win = ((w[:, :, None] - home[:, None, :]) & (T - 1)) < D   # [G, i, j]
    serial = (do[:, :, None] & active[:, None, :] & in_win
              & (j[:, None] < j[None, :])).any((1, 2))
    for reduce in ("amin", "amax"):
        assert torch.equal(_stamp_fail(w, do, active, win, T, reduce), serial)

    # serial rows: the commands in order on the image of their windows
    rows = serial.nonzero()[:, 0]
    if len(rows):
        gathered = torch.zeros((len(rows), T), dtype=torch.bool)
        r_act, c_act = active[rows].nonzero(as_tuple=True)
        gathered[r_act[:, None], win[rows][r_act, c_act].long()] = True
        img = torch.where(gathered, keys[rows], 0)
        ws, fs = w[rows].clone(), fresh[rows].clone()
        for c in range(AB):
            slots = win[rows, c].long()                            # [R, D]
            act = active[rows, c]
            assert bool(gathered.gather(1, slots)[act].all())
            k = img.gather(1, slots)
            h, e = k == stored[rows, c, None], k == 0
            p = torch.where(h.any(1), torch.argmax(h.to(I32), 1),
                            torch.argmax(e.to(I32), 1))
            d = act & (h | e).any(1)
            slot = torch.where(d, slots.gather(1, p[:, None])[:, 0], -1)
            ws[:, c], fs[:, c] = slot, d & ~h.any(1)
            r = d.nonzero()[:, 0]
            img[r, slot[r]] = stored[rows[r], c]
        w[rows], fresh[rows] = ws, fs
        do = w >= 0

    # write back: the last writer of each slot
    idx = torch.arange(AB).expand(G, AB)
    col = torch.where(do, w, T).long()
    last_of = torch.full((G, T + 1), -1, dtype=torch.int64)
    last_of.scatter_reduce_(1, col, torch.where(do, idx, -1), "amax")
    last = do & (torch.gather(last_of, 1, col) == idx)
    if not bool(serial.all()):
        # rows applied at once never write one slot twice
        assert bool((last == do)[~serial].all())
    g, c = last.nonzero(as_tuple=True)
    keys[g, w[g, c]] = stored[g, c]
    vals[g, w[g, c]] = val[g, c]
    count = count + fresh.sum(1, dtype=I32)
    return ({"keys": keys, "vals": vals, "count": count},
            (torch.where(do, val, -1), do), serial)


KEY_MODES = ("contiguous", "alias", "dense", "duplicates", "edges")


def make_case(rng, T, D, AB, G, hashed, mode, fill):
    """A table and a window of commands for one geometry (numpy, seeded)."""
    s = np.arange(T)
    if hashed:
        tk = rng.integers(0, 2 * T, size=(G, T))
    else:
        tk = s + T * rng.integers(0, 3, size=(G, T))   # a slot's aliases
    keys0 = np.where(rng.random((G, T)) < fill, tk + 1, 0).astype(np.int32)
    first = rng.integers(0, T, size=(G, 1))
    jj = np.arange(AB)[None, :]
    if mode == "contiguous":
        ck = (first + jj) & (T - 1)
    elif mode == "alias":
        ck = ((first + jj) & (T - 1)) + T * rng.integers(0, 3, size=(G, AB))
    elif mode == "dense":
        ck = rng.integers(-2, 2 * T, size=(G, AB))
    elif mode == "duplicates":
        few = rng.integers(0, 2 * T, size=(G, 3))
        ck = np.take_along_axis(few, rng.integers(0, 3, size=(G, AB)), 1)
    else:
        pool = np.array([INT_MAX, INT_MAX - T, -2**31, -1, 0, T - 1, 1])
        ck = rng.choice(pool, size=(G, AB))
    cv = rng.integers(-5, 1 << 20, size=(G, AB))
    cmds = np.stack([ck, cv], -1).astype(np.int32)
    valid = rng.random((G, AB)) < 0.85
    valid[rng.random(G) < 0.15] = False                # rows with no valid lane
    vals0 = rng.integers(-1000, 1000, size=(G, T)).astype(np.int32)
    state = {"keys": keys0, "vals": vals0,
             "count": (keys0 != 0).sum(1).astype(np.int32)}
    return state, cmds, valid


def _torch_state(state):
    return {k: torch.as_tensor(v) for k, v in state.items()}


def _assert_same(a_state, a_out, b_state, b_out):
    for f in ("keys", "vals", "count"):
        assert torch.equal(a_state[f], b_state[f]), f
    assert torch.equal(a_out[0], b_out[0])
    assert torch.equal(a_out[1], b_out[1])


def test_model_equals_sequential_arm_on_random_geometries():
    """Both branches, every key mode, wraps, duplicates and negative keys:
    the model is bitwise the sequential arm; each branch runs."""
    rows_by_branch = {"at_once": 0, "in_order": 0}
    for seed in range(160):
        rng = np.random.default_rng(seed)
        T = int(rng.choice([8, 16, 32, 64]))
        D = int(rng.integers(1, min(8, T) + 1))
        AB, G = int(rng.integers(1, 41)), int(rng.integers(1, 17))
        hashed = bool(rng.random() < 0.5)
        mode = KEY_MODES[seed % len(KEY_MODES)]
        fill = float(rng.choice([0.0, 0.3, 0.7]))
        kv = DeviceKV(table_cap=T, probe_depth=D, hash_keys=hashed)
        state, cmds, valid = make_case(rng, T, D, AB, G, hashed, mode, fill)
        st = _torch_state(state)
        c, v = torch.as_tensor(cmds), torch.as_tensor(valid)
        m_state, m_out, serial = model_apply(kv, st, c, v)
        p_state, p_out = kv.apply_kernel(st, c, v)
        _assert_same(m_state, m_out, p_state, p_out)
        rows_by_branch["in_order"] += int(serial.sum())
        rows_by_branch["at_once"] += int((~serial & v.any(1)).sum())
    assert rows_by_branch["in_order"] > 0 and rows_by_branch["at_once"] > 0, rows_by_branch


@pytest.mark.parametrize("T,D,AB", [(64, 8, 40), (64, 8, 57), (1024, 8, 64)])
def test_main_path_window_applies_at_once(T, D, AB):
    """A direct-mapped table whose slots hold their own key or nothing,
    and a contiguous window of AB <= T - D + 1 keys (wrapping included):
    every write lands on its home slot outside every later window, so no
    row runs in order."""
    rng = np.random.default_rng(T + D + AB)
    G = 32
    kv = DeviceKV(table_cap=T, probe_depth=D, hash_keys=False)
    keys0 = np.where(rng.random((G, T)) < 0.5, np.arange(T) + 1, 0).astype(np.int32)
    first = rng.integers(0, T, size=(G, 1))
    first[0] = T - 1
    ck = (first + np.arange(AB)[None, :]) & (T - 1)
    cv = rng.integers(0, 1 << 20, size=(G, AB))
    st = _torch_state({"keys": keys0, "vals": np.zeros((G, T), np.int32),
                       "count": (keys0 != 0).sum(1).astype(np.int32)})
    c = torch.as_tensor(np.stack([ck, cv], -1).astype(np.int32))
    v = torch.as_tensor(rng.random((G, AB)) < 0.9)
    m_state, m_out, serial = model_apply(kv, st, c, v)
    _assert_same(m_state, m_out, *kv.apply_kernel(st, c, v))
    assert not bool(serial.any())


# the geometries of tests/test_device_kv_pallas.py (table_cap, probe_depth,
# hash_keys, G, AB)
REF_CASES = {"hashed": (64, 8, True, 9, 16), "direct": (128, 8, False, 16, 32),
             "full_window": (8, 4, True, 4, 12)}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_model_equals_jax_reference(case):
    T, D, hashed, G, AB = REF_CASES[case]
    rng = np.random.default_rng(sorted(REF_CASES).index(case) + 1)
    mode = "contiguous" if not hashed else "dense"
    state, cmds, valid = make_case(rng, T, D, AB, G, hashed, mode, 0.3)
    kv = DeviceKV(table_cap=T, probe_depth=D, hash_keys=hashed)
    ref = RefKV(table_cap=T, probe_depth=D, hash_keys=hashed)
    r_state, (rr, rok) = ref.apply_kernel({k: jnp.asarray(v) for k, v in state.items()},
                                          jnp.asarray(cmds), jnp.asarray(valid))
    m_state, (mr, mok), _serial = model_apply(
        kv, _torch_state(state), torch.as_tensor(cmds), torch.as_tensor(valid))
    assert convert.diff_leaves({k: np.asarray(v) for k, v in r_state.items()},
                               convert.kv_state_to_numpy(m_state)) == []
    assert np.array_equal(np.asarray(rr), mr.numpy())
    assert np.array_equal(np.asarray(rok), mok.numpy())


def test_serial_rows_buffer_is_refused_on_cpu():
    """Only the kernel has branches; the plain arm refuses the buffer."""
    kv = DeviceKV(table_cap=8, probe_depth=2, hash_keys=False)
    cmds = torch.zeros((1, 2, 2), dtype=I32)
    valid = torch.ones((1, 2), dtype=torch.bool)
    with pytest.raises(ValueError, match="serial_rows"):
        apply_window(kv, kv.init_state(1, "cpu"), cmds, valid,
                     serial_rows=torch.zeros(1, dtype=torch.uint8))
