// Host-side batch preparation of the port's decode step.
//
// Between two device steps the runner assembles the decode batch: each
// running sequence's token, position and block tables go into padded
// int32 arrays. In Python loops that costs ~1-2 ms a step at batch 256.
// This library does the array assembly in one C pass. Block tables are
// plain int32 page-id arrays, so the native work is the assembly itself
// (the reference builds its pointer tables in CUDA:
// kernels/csrc/fused_attention/common/input_metadata_helper.cu:16-50).
//
// Built with the host g++ on first use (``csrc/__init__.py``) and bound
// with ctypes through this plain C interface. Every buffer is a numpy
// array the caller allocates; this code only fills it.

#include <cstdint>
#include <cstring>

extern "C" {

// Pad ragged int32 block tables into a dense [n, width] array.
// flat: concatenated tables; lens[i]: length of table i.
void pad_block_tables(const int32_t* flat, const int32_t* lens, int n,
                      int width, int32_t fill, int32_t* out /* n*width */) {
  const int32_t* src = flat;
  for (int i = 0; i < n; ++i) {
    int32_t* row = out + (int64_t)i * width;
    int len = lens[i] < width ? lens[i] : width;
    std::memcpy(row, src, (size_t)len * sizeof(int32_t));
    for (int j = len; j < width; ++j) row[j] = fill;
    src += lens[i];
  }
}

// Assemble the decode-step arrays in one pass.
// Inputs are per entry (one running sequence each):
//   slots[i]        destination row in the padded batch
//   tokens[i]       last sampled token id
//   positions[i]    index of the token being generated
//   tbl_flat/tbl_lens, stbl_flat/stbl_lens: ragged block tables
// Outputs (caller-zeroed, sized b_pad):
//   token_ids, out_positions, active(int8), bt [b_pad*w], st [b_pad*sw],
//   new_pages (appended when positions % page_size == 0; returns count)
int build_decode_batch(int n, int page_size,
                       const int32_t* slots, const int32_t* tokens,
                       const int32_t* positions,
                       const int32_t* tbl_flat, const int32_t* tbl_lens,
                       const int32_t* stbl_flat, const int32_t* stbl_lens,
                       int w, int sw,
                       int32_t* token_ids, int32_t* out_positions,
                       int8_t* active, int32_t* bt, int32_t* st,
                       int32_t* new_pages, int max_new_pages) {
  const int32_t* tsrc = tbl_flat;
  const int32_t* ssrc = stbl_flat;
  int n_new = 0;
  for (int i = 0; i < n; ++i) {
    int s = slots[i];
    token_ids[s] = tokens[i];
    out_positions[s] = positions[i];
    active[s] = 1;
    int tl = tbl_lens[i] < w ? tbl_lens[i] : w;
    std::memcpy(bt + (int64_t)s * w, tsrc, (size_t)tl * sizeof(int32_t));
    int sl = stbl_lens[i] < sw ? stbl_lens[i] : sw;
    std::memcpy(st + (int64_t)s * sw, ssrc, (size_t)sl * sizeof(int32_t));
    if (positions[i] % page_size == 0 && n_new < max_new_pages) {
      int pg = positions[i] / page_size;
      if (pg < tbl_lens[i]) new_pages[n_new++] = tsrc[pg];
    }
    tsrc += tbl_lens[i];
    ssrc += stbl_lens[i];
  }
  return n_new;
}

}  // extern "C"
