// In-memory WFST (tropical semiring) + OpenFst VectorFst<StdArc> binary I/O.
//
// Native-runtime piece of the framework: the replacement for the
// OpenFst surface the reference decoder consumes (src/fstext/, the graphs
// produced by utils/mkgraph.sh).  Only the on-disk format is shared with
// OpenFst so Kaldi-built TLG/CTC graphs load directly; the in-memory
// representation is a flat CSR layout tuned for the token-passing decoder
// (sequential arc scans, no pointer chasing).

#pragma once

#include <cstdint>
#include <limits>
#include <string>
#include <vector>

namespace ctc_native {

struct Arc {
  int32_t ilabel;
  int32_t olabel;
  float weight;      // tropical: cost, lower is better
  int32_t nextstate;
};

struct Fst {
  int64_t start = -1;
  std::vector<float> final_weight;     // +inf = not final
  std::vector<int64_t> arc_offset;     // CSR: state s arcs in
                                       // [arc_offset[s], arc_offset[s+1])
  std::vector<Arc> arcs;

  int64_t NumStates() const { return (int64_t)final_weight.size(); }
  int64_t NumArcs() const { return (int64_t)arcs.size(); }
  static constexpr float kInfinity = std::numeric_limits<float>::infinity();

  // Mutable builder-style helpers (used by the CTC graph transform).
  // These operate on an adjacency-list copy; call Rebuild to get CSR back.
};

// Adjacency-list FST for construction/mutation.
struct MutableFst {
  int64_t start = -1;
  std::vector<float> final_weight;
  std::vector<std::vector<Arc>> state_arcs;

  int64_t AddState() {
    final_weight.push_back(Fst::kInfinity);
    state_arcs.emplace_back();
    return (int64_t)final_weight.size() - 1;
  }
  void AddArc(int64_t s, const Arc& a) { state_arcs[s].push_back(a); }
  int64_t NumStates() const { return (int64_t)final_weight.size(); }

  Fst ToCsr() const;
  static MutableFst FromCsr(const Fst& f);
};

// OpenFst-compatible binary I/O (VectorFst<StdArc>, header version 2).
bool ReadVectorFst(const std::string& path, Fst* out, std::string* err);
bool WriteVectorFst(const std::string& path, const Fst& fst,
                    std::string* err);

// The CTC graph transform (reference: ctc/ctc-graph.cc:30-76
// ShiftTransitionIdAndAddBlanks): shift non-eps ilabels +1, then for each
// original state s: move non-self-loop arcs to a new state ns, connect
// s --eps--> ns, add blank (ilabel 1) self-loop on ns, keep original
// (shifted) self-loops on s.
void ShiftLabelsAndAddBlanks(MutableFst* fst);

// Weighted composition a ∘ b (tropical; naive epsilon handling — fine
// for offline graph building; see fst.cc) and connection (drop
// non-accessible / non-coaccessible states).
void AddSelfLoops(MutableFst* fst);

Fst Compose(const Fst& a, const Fst& b);
Fst Connect(const Fst& f);

// BFS state renumbering from the start state (unreachable states keep
// their relative order at the end).  Pure isomorphism — weights, paths
// and labels unchanged — but decode-critical for memory locality on
// multi-GB graphs: beam-search active sets are graph-local, so placing
// BFS-adjacent states at adjacent ids turns the per-frame offset/arc
// walks from scattered DRAM reads into near-sequential ones.  In
// particular the CTC transform appends every blank twin at id n0+s —
// maximally far from its original; BFS puts each twin right next to
// its source (the s --eps--> twin arc is the first arc discovered).
Fst RenumberBfs(const Fst& f);

// Graph-building algorithms (determinize.cc) — the native
// fstdeterminizestar / fstminimizeencoded / fstpushspecial / fstrmsymbols
// chain utils/mkgraph.sh runs on LG (mkgraph.sh:92-98).
// allow_nonfunctional: when two paths share input, weight, AND state but
// differ in output, pick the lexicographically smaller output instead of
// failing (fstdeterminizestar fails; graph building avoids the case via
// lexicon disambiguation symbols).
bool DeterminizeStar(const Fst& in, Fst* out, std::string* err,
                     int64_t max_states = 20 * 1000 * 1000,
                     bool allow_nonfunctional = false);
Fst MinimizeEncoded(const Fst& in);
Fst PushSpecial(const Fst& in, int iterations = 200);
void RemoveDisambigSymbols(MutableFst* fst, int32_t first_disambig);

}  // namespace ctc_native
