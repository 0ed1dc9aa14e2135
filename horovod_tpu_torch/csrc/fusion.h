// Tensor-fusion planner (native core).
//
// Reference equivalent: FuseResponses (horovod/common/operations.cc:577-700)
// + FusionBufferManager sizing — batch small allreduces into one wire
// collective under the fusion threshold, with look-ahead past entries of a
// different wire dtype (the reference's "skipped responses" loop) so a
// mixed-dtype stream still fuses densely; offsets are aligned to
// FUSION_BUFFER_ATOMIC_UNIT (operations.h:30).
#pragma once

#include <cstdint>
#include <vector>

namespace hvdtpu {

constexpr int64_t kFusionBufferAtomicUnit = 64;  // operations.h:30

struct FusionEntry {
  int64_t nbytes;
  int32_t dtype_id;  // wire dtype tag; only same-dtype entries fuse
};

// Assigns a group id to every entry. Entries sharing a group id execute as
// one fused collective. Group ids are dense, ordered by first member.
// Returns the number of groups.
int PlanFusion(const std::vector<FusionEntry>& entries, int64_t threshold,
               std::vector<int32_t>* group_out);

// Byte offsets of each member inside its fused buffer, aligned up to the
// atomic unit (mirrors the reference's buffer layout math).
void FusionOffsets(const std::vector<int64_t>& nbytes,
                   std::vector<int64_t>* offsets, int64_t* total);

}  // namespace hvdtpu
