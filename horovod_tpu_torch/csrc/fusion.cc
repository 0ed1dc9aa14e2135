#include "fusion.h"

#include <cstddef>

namespace hvdtpu {

static int64_t AlignUp(int64_t x, int64_t unit) {
  return (x + unit - 1) / unit * unit;
}

int PlanFusion(const std::vector<FusionEntry>& entries, int64_t threshold,
               std::vector<int32_t>* group_out) {
  const int n = static_cast<int>(entries.size());
  group_out->assign(n, -1);
  int next_group = 0;
  for (int i = 0; i < n; ++i) {
    if ((*group_out)[i] != -1) continue;
    int g = next_group++;
    (*group_out)[i] = g;
    int64_t used = AlignUp(entries[i].nbytes, kFusionBufferAtomicUnit);
    // Look-ahead: later entries of the same dtype may join this group even
    // if entries between them were skipped (different dtype or would
    // overflow) — the reference's skipped-responses re-queue loop
    // (operations.cc:648-700).
    for (int j = i + 1; j < n; ++j) {
      if ((*group_out)[j] != -1) continue;
      if (entries[j].dtype_id != entries[i].dtype_id) continue;
      int64_t need = AlignUp(entries[j].nbytes, kFusionBufferAtomicUnit);
      if (used + need > threshold) continue;
      (*group_out)[j] = g;
      used += need;
    }
  }
  return next_group;
}

void FusionOffsets(const std::vector<int64_t>& nbytes,
                   std::vector<int64_t>* offsets, int64_t* total) {
  offsets->resize(nbytes.size());
  int64_t off = 0;
  for (size_t i = 0; i < nbytes.size(); ++i) {
    (*offsets)[i] = off;
    off += AlignUp(nbytes[i], kFusionBufferAtomicUnit);
  }
  *total = off;
}

}  // namespace hvdtpu
