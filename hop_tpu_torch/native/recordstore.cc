// Parallel batch gatherer for the record store (hop_tpu_torch/data/records.py;
// a copy of hop_tpu/native/recordstore.cc).
//
// The training input pipeline assembles batches by copying fixed-schema
// records out of one mmap'd file into contiguous per-field arrays. This is
// pure memory bandwidth; doing it multithreaded in C++ replaces the
// reference's Python DataLoader workers (per-sample pyarrow deserialisation,
// reference data_loader/lmdb_data_loader.py:117-124) as the host-side data
// path.
//
// Built at first use by hop_tpu_torch/native/recordstore.py:
// g++ -O3 -shared -fPIC -o build/native/librecordstore_<hash>.so recordstore.cc -lpthread

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// base:        mmap'd file contents
// offsets:     (n_records + 1) record byte offsets, relative to header_bytes
// indices:     records to gather
// header_bytes: file header size (magic + fixed_nbytes)
// field_sizes: byte size of each fixed field, in record order
// out_ptrs:    n_fields destination arrays, each n_indices * field_sizes[f]
void gather_records(const uint8_t* base, const int64_t* offsets,
                    const int64_t* indices, int64_t n_indices,
                    int64_t header_bytes, const int64_t* field_sizes,
                    int32_t n_fields, uint8_t** out_ptrs,
                    int32_t n_threads) {
  std::vector<int64_t> field_off(n_fields);
  int64_t acc = 0;
  for (int32_t f = 0; f < n_fields; ++f) {
    field_off[f] = acc;
    acc += field_sizes[f];
  }

  auto worker = [&](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b) {
      const uint8_t* rec = base + header_bytes + offsets[indices[b]];
      for (int32_t f = 0; f < n_fields; ++f) {
        std::memcpy(out_ptrs[f] + b * field_sizes[f], rec + field_off[f],
                    static_cast<size_t>(field_sizes[f]));
      }
    }
  };

  if (n_threads <= 1 || n_indices < 4) {
    worker(0, n_indices);
    return;
  }
  int64_t nt = std::min<int64_t>(n_threads, n_indices);
  std::vector<std::thread> threads;
  int64_t chunk = (n_indices + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t b0 = t * chunk;
    int64_t b1 = std::min(n_indices, b0 + chunk);
    if (b0 >= b1) break;
    threads.emplace_back(worker, b0, b1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
