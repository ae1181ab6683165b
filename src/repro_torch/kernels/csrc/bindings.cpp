// Python bindings of the port's CUDA kernels.  The only translation unit
// that includes torch/extension.h (it is the slow header to compile); the
// kernels themselves live in *.cu files with plain pointer interfaces.
// paged_attention and paged_decode_write, which run on every layer of every
// decode step, validate shapes, dtypes, devices and contiguity here
// (TORCH_CHECK_VALUE raises ValueError, TORCH_CHECK_TYPE TypeError): the
// same checks in Python cost more host time than the call itself (PERF.md).
// So does masked_dequant, whose shapes and scale forms are read here to
// derive the kernel's strides.  The other kernels are validated by their
// Python wrappers in repro_torch/kernels/{delta_apply,flash_attention,
// quant_matmul}.py before these run; those wrappers pick the design
// (flash_attention vs flash_attention_sm90; quant_matmul vs
// quant_matmul_splitk / quant_matmul_sm90).  delta_apply_parts checks its
// packed buffer's layout here and its destinations in the wrapper.

#include <torch/extension.h>

#include <cstdint>
#include <initializer_list>
#include <utility>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

namespace repro_torch {

void launch_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                            const int32_t* tables, const int32_t* lens, float* out, float* ws,
                            int batch, int n_tab, int block_size, int kv_heads, int groups,
                            int head_dim, int cols, bool bf16, cudaStream_t stream);
int paged_attention_splits(int n_tab, int cols);

void launch_paged_decode_write(void* k_blocks, void* v_blocks, const void* new_k,
                               const void* new_v, const int32_t* block_ids,
                               const int32_t* offsets, int batch, int block_size,
                               int row, bool in_bf16, bool pool_bf16,
                               cudaStream_t stream);

void launch_delta_apply(void* buf, const void* indices, const void* values, int64_t n,
                        int64_t size, bool buf_bf16, bool val_bf16, bool idx64,
                        cudaStream_t stream);

void launch_delta_apply_parts(const void* packed, int64_t map_off, int64_t payload_off,
                              int64_t n_tiles, cudaStream_t stream);

void launch_delta_apply_one(void* buf, const void* indices, const void* values, int64_t n,
                            int64_t size, bool buf_bf16, bool val_bf16, bool idx64,
                            cudaStream_t stream);

void launch_masked_dequant(const int8_t* codes, const float* scale, const float* lo,
                           const float* hi, void* out, int64_t units, int64_t unit_rows,
                           int64_t cols, int64_t su, int64_t sr, int64_t sc, bool out_bf16,
                           cudaStream_t stream);

void launch_flash_attention(const void* q, const void* k, const void* v, float* out, int bh,
                            int sq, int sk, int groups, int head_dim, bool bf16, bool causal,
                            int window, int q_offset, cudaStream_t stream);

void launch_quant_matmul(const float* x, const int8_t* codes, const float* scale, void* out,
                         int m, int n, int k, bool out_bf16, cudaStream_t stream);

void launch_flash_attention_sm90(const void* q, const void* k, const void* v, float* out,
                                 int bh, int sq, int sk, int groups, int head_dim, bool causal,
                                 int window, int q_offset, cudaStream_t stream);

void launch_quant_matmul_splitk(const void* x, const int8_t* codes, const float* scale,
                                float* ws, void* out, int m, int n, int k, int slice_k,
                                int slices, bool out_bf16, cudaStream_t stream);

void launch_quant_matmul_sm90(const void* x, const int8_t* codes, const float* scale, void* out,
                              int m, int n, int k, bool out_bf16, cudaStream_t stream);

namespace {

bool float_or_bf16(const at::Tensor& t) {
  return t.scalar_type() == at::kFloat || t.scalar_type() == at::kBFloat16;
}

// every tensor on `device` (a CUDA device) and contiguous
void require_cuda(const char* name, const c10::Device& device,
                  std::initializer_list<std::pair<const char*, const at::Tensor*>> tensors) {
  TORCH_CHECK_VALUE(device.is_cuda(), name, ": no kernel for device ", device);
  for (const auto& [label, t] : tensors) {
    TORCH_CHECK_VALUE(t->device() == device, name, ": ", label, " on ", t->device(),
                      ", expected ", device);
    TORCH_CHECK_VALUE(t->is_contiguous(), name, ": ", label, " must be contiguous");
  }
}

}  // namespace

// q (B, H, hd); k/v pools (P, bs, KH, hd) of q's dtype (f32 or bf16); tables
// (B, T) and lens (B,) int32; ws (S, B, H, hd + 2) f32 when the wrapper's
// plan has S > 1 splits of `cols` table columns -> (B, H, hd) f32
at::Tensor paged_attention(const at::Tensor& q, const at::Tensor& k_blocks,
                           const at::Tensor& v_blocks, const at::Tensor& tables,
                           const at::Tensor& lens, const at::Tensor& ws, int64_t cols) {
  require_cuda("paged_attention", q.device(),
               {{"k_blocks", &k_blocks}, {"v_blocks", &v_blocks}, {"block_tables", &tables},
                {"context_lens", &lens}, {"q", &q}});
  TORCH_CHECK_VALUE(q.dim() == 3 && k_blocks.dim() == 4, "paged_attention: q ", q.sizes(),
                    " / k blocks ", k_blocks.sizes(), " must be (B, H, hd) / (P, bs, KH, hd)");
  const int64_t batch = q.size(0), heads = q.size(1), head_dim = q.size(2);
  const int64_t block_size = k_blocks.size(1), kv_heads = k_blocks.size(2);
  TORCH_CHECK_VALUE(v_blocks.sizes() == k_blocks.sizes() && k_blocks.size(3) == head_dim,
                    "paged_attention: k/v blocks ", k_blocks.sizes(), "/", v_blocks.sizes(),
                    " do not match q ", q.sizes());
  TORCH_CHECK_TYPE(float_or_bf16(q) && k_blocks.scalar_type() == q.scalar_type() &&
                       v_blocks.scalar_type() == q.scalar_type(),
                   "paged_attention: q/k/v must share one dtype of (Float, BFloat16), got ",
                   q.scalar_type(), "/", k_blocks.scalar_type(), "/", v_blocks.scalar_type());
  TORCH_CHECK_VALUE(head_dim == 32 || head_dim == 64 || head_dim == 128 || head_dim == 256,
                    "paged_attention: head_dim ", head_dim, " not in (32, 64, 128, 256)");
  TORCH_CHECK_VALUE(kv_heads > 0 && heads % kv_heads == 0 && heads / kv_heads <= 64,
                    "paged_attention: ", heads, " heads over ", kv_heads,
                    " kv heads (groups must divide and be <= 64)");
  TORCH_CHECK_TYPE(tables.scalar_type() == at::kInt && lens.scalar_type() == at::kInt,
                   "paged_attention: block_tables/context_lens must be int32");
  TORCH_CHECK_VALUE(tables.dim() == 2 && tables.size(0) == batch && lens.dim() == 1 &&
                        lens.size(0) == batch,
                    "paged_attention: tables ", tables.sizes(), " / lens ", lens.sizes(),
                    " for batch ", batch);
  TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(k_blocks.data_ptr()) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(v_blocks.data_ptr()) % 16 == 0,
                    "paged_attention: k/v blocks must start on 16-byte boundaries");
  const int64_t n_tab = tables.size(1);
  TORCH_CHECK_VALUE(cols >= 1 && cols <= n_tab + 1 && block_size * (n_tab + 1) < (1LL << 31),
                    "paged_attention: ", cols, " columns per split of ", n_tab);
  const int splits = paged_attention_splits(static_cast<int>(n_tab), static_cast<int>(cols));
  TORCH_CHECK_VALUE(splits <= 65535 && kv_heads <= 65535, "paged_attention: grid of ",
                    splits, " splits x ", kv_heads, " kv heads");
  if (splits > 1) {
    TORCH_CHECK_VALUE(ws.device() == q.device() && ws.scalar_type() == at::kFloat &&
                          ws.is_contiguous() &&
                          ws.sizes() == at::IntArrayRef({splits, batch, heads, head_dim + 2}),
                      "paged_attention: workspace ", ws.sizes(), " ", ws.scalar_type(),
                      ", expected [", splits, ", ", batch, ", ", heads, ", ", head_dim + 2,
                      "] Float on ", q.device());
  }
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = at::empty({batch, heads, head_dim}, q.options().dtype(at::kFloat));
  if (out.numel() == 0) return out;
  launch_paged_attention(q.data_ptr(), k_blocks.data_ptr(), v_blocks.data_ptr(),
                         tables.data_ptr<int32_t>(), lens.data_ptr<int32_t>(),
                         out.data_ptr<float>(), splits > 1 ? ws.data_ptr<float>() : nullptr,
                         static_cast<int>(batch), static_cast<int>(n_tab),
                         static_cast<int>(block_size), static_cast<int>(kv_heads),
                         static_cast<int>(heads / kv_heads), static_cast<int>(head_dim),
                         static_cast<int>(cols), q.scalar_type() == at::kBFloat16,
                         at::cuda::getCurrentCUDAStream());
  return out;
}

// the pools are written in place through their data pointers: pools (P,
// bs, KH, hd), tokens (B, KH, hd) f32 or bf16, block_ids / offsets (B,) int32
void paged_decode_write(at::Tensor k_blocks, at::Tensor v_blocks, const at::Tensor& new_k,
                        const at::Tensor& new_v, const at::Tensor& block_ids,
                        const at::Tensor& offsets) {
  require_cuda("paged_decode_write", k_blocks.device(),
               {{"k_blocks", &k_blocks}, {"v_blocks", &v_blocks}, {"new_k", &new_k},
                {"new_v", &new_v}, {"block_ids", &block_ids}, {"offsets", &offsets}});
  TORCH_CHECK_VALUE(new_k.dim() == 3 && k_blocks.dim() == 4 &&
                        new_v.sizes() == new_k.sizes() &&
                        v_blocks.sizes() == k_blocks.sizes() &&
                        k_blocks.size(2) == new_k.size(1) && k_blocks.size(3) == new_k.size(2),
                    "paged_decode_write: pools ", k_blocks.sizes(), " / tokens ",
                    new_k.sizes(), " mismatch");
  const std::initializer_list<std::pair<const char*, const at::Tensor*>> typed = {
      {"pools", &k_blocks}, {"v pool", &v_blocks}, {"new_k", &new_k}, {"new_v", &new_v}};
  for (const auto& [label, t] : typed) {
    TORCH_CHECK_TYPE(float_or_bf16(*t), "paged_decode_write: ", label, " dtype ",
                     t->scalar_type(), " not in (Float, BFloat16)");
  }
  TORCH_CHECK_TYPE(v_blocks.scalar_type() == k_blocks.scalar_type() &&
                       new_v.scalar_type() == new_k.scalar_type(),
                   "paged_decode_write: k/v dtypes differ");
  const int64_t batch = new_k.size(0);
  TORCH_CHECK_VALUE(block_ids.scalar_type() == at::kInt && offsets.scalar_type() == at::kInt &&
                        block_ids.dim() == 1 && block_ids.size(0) == batch &&
                        offsets.dim() == 1 && offsets.size(0) == batch,
                    "paged_decode_write: block_ids/offsets must be (B,) int32");
  if (new_k.numel() == 0) return;
  const c10::cuda::CUDAGuard guard(k_blocks.device());
  launch_paged_decode_write(
      k_blocks.data_ptr(), v_blocks.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
      block_ids.data_ptr<int32_t>(), offsets.data_ptr<int32_t>(), static_cast<int>(batch),
      static_cast<int>(k_blocks.size(1)), static_cast<int>(new_k.size(1) * new_k.size(2)),
      new_k.scalar_type() == at::kBFloat16, k_blocks.scalar_type() == at::kBFloat16,
      at::cuda::getCurrentCUDAStream());
}

// buf is scattered into in place through its data pointer
void delta_apply(at::Tensor buf, const at::Tensor& indices, const at::Tensor& values) {
  const c10::cuda::CUDAGuard guard(buf.device());
  launch_delta_apply(buf.data_ptr(), indices.data_ptr(), values.data_ptr(), indices.numel(),
                     buf.numel(), buf.scalar_type() == at::kBFloat16,
                     values.scalar_type() == at::kBFloat16,
                     indices.scalar_type() == at::kLong, at::cuda::getCurrentCUDAStream());
}

// the single-part in-place form: the parts kernel with one rows segment
void delta_apply_inplace(at::Tensor buf, const at::Tensor& indices, const at::Tensor& values) {
  const c10::cuda::CUDAGuard guard(buf.device());
  launch_delta_apply_one(buf.data_ptr(), indices.data_ptr(), values.data_ptr(), indices.numel(),
                         buf.numel(), buf.scalar_type() == at::kBFloat16,
                         values.scalar_type() == at::kBFloat16,
                         indices.scalar_type() == at::kLong, at::cuda::getCurrentCUDAStream());
}

// packed (nbytes,) uint8 on the card: the segment table at byte 0, the tile
// map at map_off, the payload at payload_off (kernels/delta_apply.py packs
// it and checks every destination the table names)
void delta_apply_parts(const at::Tensor& packed, int64_t map_off, int64_t payload_off,
                       int64_t n_tiles) {
  require_cuda("delta_apply_parts", packed.device(), {{"packed", &packed}});
  TORCH_CHECK_TYPE(packed.scalar_type() == at::kByte,
                   "delta_apply_parts: packed must be uint8, got ", packed.scalar_type());
  TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(packed.data_ptr()) % 16 == 0 &&
                        map_off % 16 == 0 && payload_off % 16 == 0,
                    "delta_apply_parts: the packed buffer and its sections must be "
                    "16-byte aligned");
  TORCH_CHECK_VALUE(n_tiles >= 0 && n_tiles <= INT32_MAX && map_off >= 0 &&
                        map_off + 4 * n_tiles <= payload_off && payload_off <= packed.numel(),
                    "delta_apply_parts: ", n_tiles, " tiles, map at ", map_off,
                    ", payload at ", payload_off, " do not fit ", packed.numel(), " bytes");
  const c10::cuda::CUDAGuard guard(packed.device());
  launch_delta_apply_parts(packed.data_ptr(), map_off, payload_off, n_tiles,
                           at::cuda::getCurrentCUDAStream());
}

// codes (R, C) or (U, R, C) int8; scale f32 of codes' rank, broadcast to it
// as per column (.., 1, C), per row (.., R, 1) or scalar (.., 1, 1), its
// leading axis U or 1; lo / hi (8,) f32 -> codes' shape, bf16 or f32
at::Tensor masked_dequant(const at::Tensor& codes, const at::Tensor& scale,
                          const at::Tensor& lo, const at::Tensor& hi, bool out_bf16) {
  require_cuda("masked_dequant", codes.device(),
               {{"codes", &codes}, {"scale", &scale}, {"lo", &lo}, {"hi", &hi}});
  TORCH_CHECK_TYPE(codes.scalar_type() == at::kChar, "masked_dequant: codes must be int8, got ",
                   codes.scalar_type());
  TORCH_CHECK_TYPE(scale.scalar_type() == at::kFloat && lo.scalar_type() == at::kFloat &&
                       hi.scalar_type() == at::kFloat,
                   "masked_dequant: scale/lo/hi must be float32, got ", scale.scalar_type(),
                   "/", lo.scalar_type(), "/", hi.scalar_type());
  TORCH_CHECK_VALUE(lo.dim() == 1 && lo.size(0) == 8 && hi.sizes() == lo.sizes(),
                    "masked_dequant: lo/hi must be (8,), got ", lo.sizes(), " / ", hi.sizes());
  TORCH_CHECK_VALUE(codes.dim() == 2 || codes.dim() == 3, "masked_dequant: codes ",
                    codes.sizes(), " must be (R, C) or (U, R, C)");
  const bool stacked = codes.dim() == 3;
  const int64_t units = stacked ? codes.size(0) : 1;
  const int64_t rows = codes.size(-2), cols = codes.size(-1);
  TORCH_CHECK_VALUE(scale.dim() == codes.dim(), "masked_dequant: scale ", scale.sizes(),
                    " must have the rank of codes ", codes.sizes());
  const int64_t s_units = stacked ? scale.size(0) : 1;
  const int64_t s_rows = scale.size(-2), s_cols = scale.size(-1);
  const bool per_column = s_rows == 1 && s_cols == cols;
  const bool per_row = s_rows == rows && s_cols == 1;
  TORCH_CHECK_VALUE((s_units == units || s_units == 1) &&
                        (per_column || per_row || (s_rows == 1 && s_cols == 1)),
                    "masked_dequant: scale ", scale.sizes(), " not broadcastable to codes ",
                    codes.sizes(), " as per column, per row or scalar");
  const int64_t su = s_units == 1 ? 0 : s_rows * s_cols;
  const int64_t sr = per_column ? 0 : (per_row ? 1 : 0);
  const int64_t sc = per_column ? 1 : 0;
  const c10::cuda::CUDAGuard guard(codes.device());
  auto out = at::empty(codes.sizes(), codes.options().dtype(out_bf16 ? at::kBFloat16
                                                                     : at::kFloat));
  launch_masked_dequant(codes.data_ptr<int8_t>(), scale.data_ptr<float>(),
                        lo.data_ptr<float>(), hi.data_ptr<float>(), out.data_ptr(), units,
                        rows, cols, su, sr, sc, out_bf16, at::cuda::getCurrentCUDAStream());
  return out;
}

at::Tensor flash_attention(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                           bool causal, int64_t window, int64_t q_offset, int64_t groups) {
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = at::empty(q.sizes(), q.options().dtype(at::kFloat));
  launch_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr<float>(),
                         static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
                         static_cast<int>(k.size(1)), static_cast<int>(groups),
                         static_cast<int>(q.size(2)), q.scalar_type() == at::kBFloat16, causal,
                         static_cast<int>(window), static_cast<int>(q_offset),
                         at::cuda::getCurrentCUDAStream());
  return out;
}

// the mma.sync design: f32 x (M, K), codes (K, N) int8, scale (N,) f32 ->
// (M, N) bf16 or f32
at::Tensor quant_matmul(const at::Tensor& x, const at::Tensor& codes, const at::Tensor& scale,
                        bool out_bf16) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t m = x.size(0), k = x.size(1), n = codes.size(1);
  auto out = at::empty({m, n}, x.options().dtype(out_bf16 ? at::kBFloat16 : at::kFloat));
  launch_quant_matmul(x.data_ptr<float>(), codes.data_ptr<int8_t>(), scale.data_ptr<float>(),
                      out.data_ptr(), static_cast<int>(m), static_cast<int>(n),
                      static_cast<int>(k), out_bf16, at::cuda::getCurrentCUDAStream());
  return out;
}

// the wgmma design: bf16 q/k/v, head_dim 64 or 128
at::Tensor flash_attention_sm90(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                                bool causal, int64_t window, int64_t q_offset, int64_t groups) {
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = at::empty(q.sizes(), q.options().dtype(at::kFloat));
  launch_flash_attention_sm90(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr<float>(),
                              static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
                              static_cast<int>(k.size(1)), static_cast<int>(groups),
                              static_cast<int>(q.size(2)), causal, static_cast<int>(window),
                              static_cast<int>(q_offset), at::cuda::getCurrentCUDAStream());
  return out;
}

// bf16 x (M <= 32, K), codes (K, N) int8, scale (N,) f32; ws (slices, M, N)
// f32 holds the K slices' partials -> (M, N) bf16 or f32
at::Tensor quant_matmul_splitk(const at::Tensor& x, const at::Tensor& codes,
                               const at::Tensor& scale, at::Tensor ws, int64_t slice_k,
                               bool out_bf16) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t m = x.size(0), k = x.size(1), n = codes.size(1);
  auto out = at::empty({m, n}, x.options().dtype(out_bf16 ? at::kBFloat16 : at::kFloat));
  launch_quant_matmul_splitk(x.data_ptr(), codes.data_ptr<int8_t>(), scale.data_ptr<float>(),
                             ws.data_ptr<float>(), out.data_ptr(), static_cast<int>(m),
                             static_cast<int>(n), static_cast<int>(k),
                             static_cast<int>(slice_k), static_cast<int>(ws.size(0)), out_bf16,
                             at::cuda::getCurrentCUDAStream());
  return out;
}

// bf16 x (M, K), codes (K, N) int8, scale (N,) f32 -> (M, N) bf16 or f32
at::Tensor quant_matmul_sm90(const at::Tensor& x, const at::Tensor& codes,
                             const at::Tensor& scale, bool out_bf16) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t m = x.size(0), k = x.size(1), n = codes.size(1);
  auto out = at::empty({m, n}, x.options().dtype(out_bf16 ? at::kBFloat16 : at::kFloat));
  launch_quant_matmul_sm90(x.data_ptr(), codes.data_ptr<int8_t>(), scale.data_ptr<float>(),
                           out.data_ptr(), static_cast<int>(m), static_cast<int>(n),
                           static_cast<int>(k), out_bf16, at::cuda::getCurrentCUDAStream());
  return out;
}

}  // namespace repro_torch

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("paged_attention", &repro_torch::paged_attention,
        "decode attention through a block table, split over the context; (B, H, hd) f32");
  m.def("paged_decode_write", &repro_torch::paged_decode_write,
        "in-place write of one K/V token per lane into the block pools");
  m.def("delta_apply", &repro_torch::delta_apply,
        "scatter buf[indices] = values into buf, out-of-range indices dropped");
  m.def("delta_apply_inplace", &repro_torch::delta_apply_inplace,
        "in-place scatter through the parts kernel, one rows segment");
  m.def("delta_apply_parts", &repro_torch::delta_apply_parts,
        "every part of a staged-sync step (rows and chunk pages) from one packed buffer");
  m.def("masked_dequant", &repro_torch::masked_dequant,
        "int8 codes * scale with the license intervals zeroed, one launch per (U, R, C) leaf");
  m.def("flash_attention", &repro_torch::flash_attention,
        "causal / windowed / offset online-softmax attention, GQA; (BH, Sq, hd) f32");
  m.def("quant_matmul", &repro_torch::quant_matmul,
        "x @ (int8 codes * per-column scale), f32 accumulation, one cast");
  m.def("flash_attention_sm90", &repro_torch::flash_attention_sm90,
        "flash_attention on wgmma with a cp.async K/V ring (bf16, hd 64 / 128)");
  m.def("quant_matmul_splitk", &repro_torch::quant_matmul_splitk,
        "quant_matmul for small M: weight-stationary mma.sync split over K, fixed-order sum");
  m.def("quant_matmul_sm90", &repro_torch::quant_matmul_sm90,
        "quant_matmul for large M: wgmma with a cp.async ring, codes converted in shared memory");
}
