// Lattice-generating token-passing decoder.
//
// Native replacement for the reference's lattice path:
// LatticeFasterDecoder::GetRawLattice + lattice-beam pruning
// (decoder/lattice-faster-decoder.h:40-96, PruneForwardLinks/
// PruneTokensForFrame) as driven by DecodeUtteranceLatticeFasterCtc
// (ctc/ctc-decoder-wrappers.cc:27-126).  Differences from the reference
// are structural, not semantic: the acoustic model already ran on the
// device, so acoustic costs come from a dense score matrix instead of a lazy
// DecodableInterface, and pruning is one exact forward-backward pass over
// the surviving link DAG after decoding instead of the reference's
// periodic incremental pruning (same final lattice for the same beams,
// simpler invariants).
//
// Weights are LatticeWeight-style pairs (graph_cost, acoustic_cost) so
// downstream scaling (lattice-scale semantics) can re-weight the two
// components independently.

#pragma once

#include <cstdint>
#include <vector>

#include "decoder.h"
#include "fst.h"

namespace ctc_native {

struct LatticeOptions {
  float beam = 16.0f;
  int32_t max_active = 7000;
  float acoustic_scale = 1.0f;   // applied to -scores during search
  float lattice_beam = 10.0f;    // forward-backward pruning margin
};

// Raw lattice: DAG of surviving tokens. State 0 is the start state.
// States are topologically ordered by (frame, discovery); arcs go
// forward in that order except within-frame epsilon arcs, which still
// never form cycles (improvement-only relaxation).
struct RawLattice {
  int64_t num_states = 0;
  int64_t start = 0;
  std::vector<int32_t> arc_from;
  std::vector<int32_t> arc_to;
  std::vector<int32_t> arc_ilabel;   // graph labels (already CTC-shifted)
  std::vector<int32_t> arc_olabel;   // word ids
  std::vector<float> arc_graph_cost;
  std::vector<float> arc_acoustic_cost;
  std::vector<float> final_cost;     // per state; +inf = not final
  std::vector<int32_t> state_frame;  // frame index per state (diagnostics)
  bool reached_final = false;
  float best_cost = 0.0f;            // cost of the best complete path
};

// scores/ilabel_map as in DecodeBestPath (decoder.h).  On success fills
// *out with the lattice pruned to lattice_beam around the best path.
bool DecodeLattice(const Fst& fst, const float* scores, int64_t num_frames,
                   int64_t num_cols, const int32_t* ilabel_map,
                   int64_t map_size, const LatticeOptions& opts,
                   RawLattice* out);

// As above with a prebuilt (shareable) arc index.
bool DecodeLattice(const Fst& fst, const DecodeIndex& idx,
                   const float* scores, int64_t num_frames,
                   int64_t num_cols, const int32_t* ilabel_map,
                   int64_t map_size, const LatticeOptions& opts,
                   RawLattice* out);

}  // namespace ctc_native
