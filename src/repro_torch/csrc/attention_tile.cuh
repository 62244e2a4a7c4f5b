// The masked score of the port's attention kernels (paged_flash_decode,
// paged_flash_verify, flash_decode, through split_decode.cuh): a key a
// query row does not see scores NEG_INF, as in the Pallas kernels, so
// exp(NEG_INF - m) is 0 once the row has seen a key.
#pragma once

namespace attn {

constexpr float NEG_INF = -1.0e30f;

}  // namespace attn
