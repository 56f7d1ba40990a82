// Token-passing WFST beam decoder.
//
// Native replacement for the reference's LatticeFasterDecoder usage in
// CTC decoding (decoder/lattice-faster-decoder.h:40-96,129,342-346 via
// ctc/ctc-decoder-wrappers.cc:27-126): per frame ProcessEmitting over the
// CTC graph with acoustic costs pulled from a precomputed score matrix
// (the device forward pass already ran — the lazy DecodableInterface
// collapses to an array lookup), then epsilon-closure ProcessNonemitting,
// with beam + max-active histogram pruning.  Backpointers give the best
// path (words + per-frame ilabel alignment).

#pragma once

#include <cstdint>
#include <vector>

#include "fst.h"

namespace ctc_native {

struct DecodeOptions {
  float beam = 16.0f;
  int32_t max_active = 7000;
  int32_t min_active = 200;
  float acoustic_scale = 1.0f;   // applied to -scores
};

struct DecodeResult {
  bool reached_final = false;
  float total_cost = 0.0f;
  std::vector<int32_t> words;      // olabels on the best path
  std::vector<int32_t> alignment;  // ilabel per frame (graph labels)
};

// Decoder-side arc index: per state, epsilon arcs first then emitting
// arcs, with the split point recorded.  Both hot loops (epsilon closure
// and emitting expansion) then iterate exactly the arcs they need with
// no per-arc ilabel branch — on CTC graphs (every original state grows
// an epsilon arc to its blank twin) roughly a third of all arc visits
// were branch-and-skip.  O(arcs) to build; share across a batch.
struct DecodeIndex {
  std::vector<int64_t> eps_end;  // absolute index of first emitting arc
  // Canonical eps-first arc view.  Usually points straight at fst.arcs
  // (zero copy — on an 80M-arc graph the old always-copy design added
  // 1.3 GB to the decode working set, which is what a bandwidth-bound
  // decode streams); `owned` holds a reordered copy only when the FST
  // was not already eps-first and could not be reordered in place.
  const Arc* arcs = nullptr;
  std::vector<Arc> owned;

  // `arcs` may point into `owned`: a copy would duplicate the vector
  // but alias the source's buffer (dangling once the source dies).
  // Move keeps the pointer valid (vector move preserves data()).
  DecodeIndex() = default;
  DecodeIndex(const DecodeIndex&) = delete;
  DecodeIndex& operator=(const DecodeIndex&) = delete;
  DecodeIndex(DecodeIndex&&) = default;
  DecodeIndex& operator=(DecodeIndex&&) = default;
};

// Stable-reorders each state's arcs eps-first IN PLACE and returns true
// if anything moved.  Per-state arc order is semantically free, so this
// is safe on any FST that is not being concurrently read.
bool CanonicalizeEpsFirst(Fst* fst);

DecodeIndex BuildDecodeIndex(const Fst& fst);

// scores: [num_frames, num_cols] row-major log-likelihood-style scores
// (higher better).  ilabel_map: ilabel -> column (size max_ilabel+1);
// entries < 0 mean "no score" (arc treated as non-emitting is NOT allowed;
// ilabel 0 is epsilon and never looked up).
bool DecodeBestPath(const Fst& fst, const float* scores, int64_t num_frames,
                    int64_t num_cols, const int32_t* ilabel_map,
                    int64_t map_size, const DecodeOptions& opts,
                    DecodeResult* result);

// As above with a prebuilt (shareable) arc index.
bool DecodeBestPath(const Fst& fst, const DecodeIndex& idx,
                    const float* scores, int64_t num_frames,
                    int64_t num_cols, const int32_t* ilabel_map,
                    int64_t map_size, const DecodeOptions& opts,
                    DecodeResult* result);

// Decode a batch of utterances across worker threads (the in-process
// analogue of decode.sh's nj-way parallel jobs, steps/ctc/decode.sh:
// 151-164).  scores holds the utterances back-to-back; utterance u spans
// rows [frame_offsets[u], frame_offsets[u+1]).  Returns the number of
// utterances decoded successfully; per-utterance failures leave an empty
// DecodeResult.  num_threads <= 0 means hardware concurrency.
int DecodeBestPathBatch(const Fst& fst, const float* scores,
                        const int64_t* frame_offsets, int64_t num_utts,
                        int64_t num_cols, const int32_t* ilabel_map,
                        int64_t map_size, const DecodeOptions& opts,
                        std::vector<DecodeResult>* results,
                        std::vector<int>* ok_flags, int num_threads);

// As above with a prebuilt (shareable) arc index.
int DecodeBestPathBatch(const Fst& fst, const DecodeIndex& idx,
                        const float* scores,
                        const int64_t* frame_offsets, int64_t num_utts,
                        int64_t num_cols, const int32_t* ilabel_map,
                        int64_t map_size, const DecodeOptions& opts,
                        std::vector<DecodeResult>* results,
                        std::vector<int>* ok_flags, int num_threads);

}  // namespace ctc_native
