"""Python interface to the native WFST decoder (ctypes).

Wraps native/{fst,decoder,api}.cc: OpenFst-compatible graph loading, the
CTC graph transform (ShiftTransitionIdAndAddBlanks), and token-passing
best-path beam decoding over device-computed acoustic scores.  The shared
library is built on demand with the repo's native/Makefile.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

__all__ = ["NativeFst", "decode_best_path", "decode_best_path_batch",
           "ensure_built"]

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libctc_native.so")
_NATIVE_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_lib = None


def _host_arch_stamp() -> str:
    """Identifies the CPU the library was built for.  The Makefile uses
    -march=native, so a .so copied between machines (mtimes preserved)
    could SIGILL; the stamp forces a rebuild when the host changes."""
    import hashlib
    import platform
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    return platform.machine() + ":" + hashlib.sha256(
        flags.encode()).hexdigest()[:16]


def ensure_built() -> str:
    """Build the shared library if missing/stale; return its path."""
    srcs = [os.path.join(_NATIVE_DIR, n)
            for n in ("fst.cc", "determinize.cc", "decoder.cc",
                      "lattice.cc", "api.cc",
                      "fst.h", "decoder.h", "lattice.h", "Makefile")]
    stamp_path = _LIB_PATH + ".buildinfo"
    stamp = _host_arch_stamp()
    stale = (not os.path.exists(_LIB_PATH)
             or any(os.path.getmtime(s) > os.path.getmtime(_LIB_PATH)
                    for s in srcs if os.path.exists(s)))
    if not stale:
        try:
            with open(stamp_path) as f:
                stale = f.read().strip() != stamp
        except OSError:
            stale = True
        if stale:
            # Arch mismatch: mtimes may still say "up to date" (a .so copied
            # with preserved timestamps), so plain `make` would no-op and a
            # rewritten stamp would mask the mismatch forever.  Remove the
            # binary so the rebuild is unconditional.
            try:
                os.remove(_LIB_PATH)
            except OSError:
                pass
    if stale:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
        if not os.path.exists(_LIB_PATH):
            raise RuntimeError(
                f"native build did not produce {_LIB_PATH}")
        with open(stamp_path, "w") as f:
            f.write(stamp + "\n")
    return _LIB_PATH


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_built())
    lib.ctcn_fst_load.restype = ctypes.c_void_p
    lib.ctcn_fst_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int]
    lib.ctcn_fst_from_arrays.restype = ctypes.c_void_p
    lib.ctcn_fst_from_arrays.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    lib.ctcn_fst_free.argtypes = [ctypes.c_void_p]
    for name in ("ctcn_fst_num_states", "ctcn_fst_num_arcs",
                 "ctcn_fst_start"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.ctcn_fst_write.restype = ctypes.c_int
    lib.ctcn_fst_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ctcn_make_ctc_graph.restype = ctypes.c_void_p
    lib.ctcn_make_ctc_graph.argtypes = [ctypes.c_void_p]
    lib.ctcn_fst_compose.restype = ctypes.c_void_p
    lib.ctcn_fst_compose.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ctcn_add_self_loops.restype = ctypes.c_void_p
    lib.ctcn_add_self_loops.argtypes = [ctypes.c_void_p]
    lib.ctcn_fst_determinize_star.restype = ctypes.c_void_p
    lib.ctcn_fst_determinize_star.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int]
    for name in ("ctcn_fst_minimize", "ctcn_fst_push_special",
                 "ctcn_fst_connect", "ctcn_fst_renumber_bfs"):
        getattr(lib, name).restype = ctypes.c_void_p
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.ctcn_fst_remove_disambig.restype = ctypes.c_void_p
    lib.ctcn_fst_remove_disambig.argtypes = [ctypes.c_void_p,
                                             ctypes.c_int32]
    lib.ctcn_fst_get_arrays.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.ctcn_det_lattice.restype = ctypes.c_void_p
    lib.ctcn_det_lattice.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_int64]
    lib.ctcn_clat_free.argtypes = [ctypes.c_void_p]
    for name in ("ctcn_clat_num_states", "ctcn_clat_num_arcs",
                 "ctcn_clat_start", "ctcn_clat_arc_ilabels_size",
                 "ctcn_clat_final_ilabels_size"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.ctcn_clat_get_arcs.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.ctcn_clat_get_finals.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32)]
    lib.ctcn_decode_best_path.restype = ctypes.c_int
    lib.ctcn_decode_best_path.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_float, ctypes.c_int32, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    lib.ctcn_decode_best_path_batch.restype = ctypes.c_int
    lib.ctcn_decode_best_path_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_float, ctypes.c_int32, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    lib.ctcn_decode_lattice.restype = ctypes.c_void_p
    lib.ctcn_decode_lattice.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_float, ctypes.c_int32, ctypes.c_float, ctypes.c_float]
    lib.ctcn_lat_free.argtypes = [ctypes.c_void_p]
    for name in ("ctcn_lat_num_states", "ctcn_lat_num_arcs",
                 "ctcn_lat_start"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.ctcn_lat_reached_final.restype = ctypes.c_int
    lib.ctcn_lat_reached_final.argtypes = [ctypes.c_void_p]
    lib.ctcn_lat_best_cost.restype = ctypes.c_float
    lib.ctcn_lat_best_cost.argtypes = [ctypes.c_void_p]
    lib.ctcn_lat_get_arcs.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.ctcn_lat_get_finals.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_float)]
    lib.ctcn_lat_get_frames.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


class NativeFst:
    """Owns a native Fst handle."""

    def __init__(self, handle: int):
        self._lib = _load()
        self._h = handle
        if not self._h:
            raise ValueError("null FST handle")

    @staticmethod
    def load(path: str) -> "NativeFst":
        lib = _load()
        err = ctypes.create_string_buffer(512)
        h = lib.ctcn_fst_load(path.encode(), err, len(err))
        if not h:
            raise IOError(err.value.decode() or f"failed to load {path}")
        return NativeFst(h)

    @staticmethod
    def from_arrays(start: int, num_states: int, arcs: np.ndarray,
                    weights: np.ndarray, finals: np.ndarray) -> "NativeFst":
        """arcs [N,4] int32 (state, ilabel, olabel, nextstate)."""
        lib = _load()
        arcs = np.ascontiguousarray(arcs, np.int32)
        weights = np.ascontiguousarray(weights, np.float32)
        finals = np.ascontiguousarray(finals, np.float32)
        h = lib.ctcn_fst_from_arrays(
            start, num_states, arcs.shape[0],
            arcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            finals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return NativeFst(h)

    @property
    def num_states(self) -> int:
        return self._lib.ctcn_fst_num_states(self._h)

    @property
    def num_arcs(self) -> int:
        return self._lib.ctcn_fst_num_arcs(self._h)

    @property
    def start(self) -> int:
        return self._lib.ctcn_fst_start(self._h)

    def write(self, path: str) -> None:
        if self._lib.ctcn_fst_write(self._h, path.encode()) != 0:
            raise IOError(f"failed to write {path}")

    def make_ctc_graph(self) -> "NativeFst":
        """ShiftTransitionIdAndAddBlanks (ctc-graph.cc:30-76)."""
        return NativeFst(self._lib.ctcn_make_ctc_graph(self._h))

    def compose(self, other: "NativeFst") -> "NativeFst":
        """self ∘ other (tropical), connected (fsttablecompose +
        fstconnect analogue for graph building)."""
        return NativeFst(self._lib.ctcn_fst_compose(self._h, other._h))

    def add_self_loops(self) -> "NativeFst":
        """add-self-loops --ctc=true (hmm-utils.cc:504-509): per emitting
        arc, a self-loop state so sustained frames stay on the arc's
        label; run before make_ctc_graph when building from L ∘ G."""
        return NativeFst(self._lib.ctcn_add_self_loops(self._h))

    def determinize_star(self, max_states: int = 0,
                         allow_nonfunctional: bool = False) -> "NativeFst":
        """Subset determinization with input-epsilon removal
        (fstdeterminizestar, fstext/determinize-star.h semantics).
        Raises RuntimeError if the input is not determinizable or not
        functional (use lexicon disambiguation symbols; or pass
        allow_nonfunctional to resolve same-input-same-weight output
        conflicts toward the lexicographically smaller output).
        max_states 0 = default cap."""
        err = ctypes.create_string_buffer(1024)
        h = self._lib.ctcn_fst_determinize_star(self._h, err, len(err),
                                                max_states,
                                                int(allow_nonfunctional))
        if not h:
            raise RuntimeError(err.value.decode()
                               or "determinize-star failed")
        return NativeFst(h)

    def minimize(self) -> "NativeFst":
        """Encoded minimization (fstminimizeencoded): bisimulation
        partition refinement over (ilabel, olabel, weight) atoms."""
        return NativeFst(self._lib.ctcn_fst_minimize(self._h))

    def push_special(self) -> "NativeFst":
        """fstpushspecial: reweight so every state's outgoing probability
        mass is the same constant (path weights exactly preserved) —
        improves pruned-search behavior."""
        return NativeFst(self._lib.ctcn_fst_push_special(self._h))

    def remove_disambig(self, first_disambig: int) -> "NativeFst":
        """Map ilabels >= first_disambig to epsilon (fstrmsymbols on the
        lexicon disambiguation range, mkgraph.sh's post-determinize
        cleanup)."""
        return NativeFst(self._lib.ctcn_fst_remove_disambig(
            self._h, first_disambig))

    def renumber_bfs(self) -> "NativeFst":
        """BFS state renumbering from the start state (isomorphism).

        Decode-critical on multi-GB graphs: beam-search active sets are
        graph-local, so BFS-adjacent ids make the per-frame offset/arc
        walks near-sequential; in particular each CTC blank twin moves
        from id n0+s to the slot right after its original state."""
        return NativeFst(self._lib.ctcn_fst_renumber_bfs(self._h))

    def connect(self) -> "NativeFst":
        """fstconnect: drop non-accessible/non-coaccessible states."""
        return NativeFst(self._lib.ctcn_fst_connect(self._h))

    def to_arrays(self):
        """→ (start, arcs [N,4] int32 (state, ilabel, olabel, nextstate),
        weights [N] f32, finals [S] f32) — inverse of from_arrays."""
        n_arcs, n_states = self.num_arcs, self.num_states
        arcs = np.zeros((n_arcs, 4), np.int32)
        weights = np.zeros(n_arcs, np.float32)
        finals = np.zeros(max(n_states, 1), np.float32)
        self._lib.ctcn_fst_get_arrays(
            self._h, arcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            finals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return self.start, arcs, weights, finals[:n_states]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ctcn_fst_free(self._h)
            self._h = None


def decode_best_path(
    fst: NativeFst,
    scores: np.ndarray,                 # [T, A] higher-better log scores
    ilabel_map: Optional[np.ndarray] = None,  # ilabel -> column
    beam: float = 16.0,
    max_active: int = 7000,
    acoustic_scale: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, float, bool]:
    """→ (words, alignment_ilabels, total_cost, reached_final).

    Default ilabel_map is the CTC-graph convention: ilabel i → score
    column i-1 (graph labels are shifted +1; blank ilabel 1 → column 0).
    """
    lib = _load()
    scores = np.ascontiguousarray(scores, np.float32)
    t, a = scores.shape
    if ilabel_map is None:
        ilabel_map = np.concatenate(
            [[-1], np.arange(a, dtype=np.int32)]).astype(np.int32)
    ilabel_map = np.ascontiguousarray(ilabel_map, np.int32)
    max_out = t + 8
    words = np.zeros(max_out, np.int32)
    align = np.zeros(max_out, np.int32)
    n_words = ctypes.c_int64()
    n_align = ctypes.c_int64()
    cost = ctypes.c_float()
    final = ctypes.c_int32()
    rc = lib.ctcn_decode_best_path(
        fst._h, scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t, a, ilabel_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ilabel_map.shape[0], beam, max_active, acoustic_scale,
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_out,
        ctypes.byref(n_words),
        align.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_out,
        ctypes.byref(n_align), ctypes.byref(cost), ctypes.byref(final))
    if rc != 0:
        raise RuntimeError("decode failed (all tokens pruned?)")
    return (words[: n_words.value].copy(), align[: n_align.value].copy(),
            float(cost.value), bool(final.value))


def decode_best_path_batch(
    fst: NativeFst,
    scores_list,                        # sequence of [T_u, A] arrays
    ilabel_map: Optional[np.ndarray] = None,
    beam: float = 16.0,
    max_active: int = 7000,
    acoustic_scale: float = 1.0,
    num_threads: int = 0,
):
    """Decode many utterances across native worker threads (the
    in-process analogue of decode.sh's nj-way parallel jobs).

    -> list of (words, alignment, total_cost, ok) per utterance."""
    lib = _load()
    scores_list = [np.ascontiguousarray(s, np.float32) for s in scores_list]
    if not scores_list:
        return []
    a = scores_list[0].shape[1]
    offsets = np.zeros(len(scores_list) + 1, np.int64)
    for i, s in enumerate(scores_list):
        if s.shape[1] != a:
            raise ValueError("inconsistent score widths")
        offsets[i + 1] = offsets[i] + s.shape[0]
    packed = (np.concatenate(scores_list, axis=0)
              if len(scores_list) > 1 else scores_list[0])
    packed = np.ascontiguousarray(packed, np.float32)
    if ilabel_map is None:
        ilabel_map = np.concatenate(
            [[-1], np.arange(a, dtype=np.int32)]).astype(np.int32)
    ilabel_map = np.ascontiguousarray(ilabel_map, np.int32)
    n = len(scores_list)
    max_out = int(max(s.shape[0] for s in scores_list)) + 8
    words = np.zeros((n, max_out), np.int32)
    align = np.zeros((n, max_out), np.int32)
    n_words = np.zeros(n, np.int64)
    n_align = np.zeros(n, np.int64)
    costs = np.zeros(n, np.float32)
    ok = np.zeros(n, np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.ctcn_decode_best_path_batch(
        fst._h, packed.ctypes.data_as(f32), offsets.ctypes.data_as(i64),
        n, a, ilabel_map.ctypes.data_as(i32), ilabel_map.shape[0],
        beam, max_active, acoustic_scale, num_threads,
        words.ctypes.data_as(i32), max_out, n_words.ctypes.data_as(i64),
        align.ctypes.data_as(i32), max_out, n_align.ctypes.data_as(i64),
        costs.ctypes.data_as(f32), ok.ctypes.data_as(i32))
    out = []
    for u in range(n):
        out.append((words[u, : n_words[u]].copy(),
                    align[u, : n_align[u]].copy(),
                    float(costs[u]), bool(ok[u])))
    return out
