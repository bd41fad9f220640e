// The continuous NUTS machine with the diagonal metric (the machine itself is
// in fused_nuts_dc.cuh), the kernel's own threefry2x32 as an export with a key
// per element, and jax.random.normal's transform of the threefry words: the
// port's jax.random draws through both, each checked bit for bit against its
// plain version.
#define BJT_DC_METRIC kDiag
#include "fused_nuts_dc.cuh"

namespace {

// one block per element, each under its own key: the port's jax.random
// (blackjax_tpu_torch/prng.py) derives every chain's keys through it. Words
// travel as int64 (PyTorch's integer type): the low 32 bits in, the word in
// [0, 2^32) out.
__global__ void threefry_kernel(const int64_t* k0, const int64_t* k1, const int64_t* c0,
                                const int64_t* c1, int64_t* o0, int64_t* o1, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x0, x1;
  threefry2x32((uint32_t)k0[i], (uint32_t)k1[i], (uint32_t)c0[i], (uint32_t)c1[i], x0, x1);
  o0[i] = (int64_t)x0;
  o1[i] = (int64_t)x1;
}

}  // namespace

extern "C" int bjt_threefry2x32(const int64_t* k0, const int64_t* k1, const int64_t* c0,
                                const int64_t* c1, int64_t* o0, int64_t* o1, int n,
                                void* stream) {
  if (n <= 0) return cudaSuccess;
  threefry_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, c0, c1, o0, o1, n);
  return cudaGetLastError();
}

namespace {

// jax.random.normal's transform of its threefry words, one thread an element,
// as blackjax_tpu_torch/prng.py's plain version computes it (normal_from_words:
// the uniform on [nextafter(-1, 0), 1) from the words, then sqrt(2) times XLA's
// compiled erf_inv over XLA's CPU log1p). The constants, each a double rounded
// to the draw's type as the plain version rounds it, and the order are the
// plain version's; a multiply-add is fused (__fma_rn) exactly where the plain
// version fuses one (torch.addcmul), every other operation rounds alone (this
// file builds with --fmad=false), and division and square root are correctly
// rounded, as on the CPU. So float32 draws are the CPU's bits; float64 takes
// CUDA's log, as torch's does on the card.
__constant__ double kErfInvA32[9] = {
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941};
__constant__ double kErfInvB32[9] = {
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682};
__constant__ double kErfInvA64[23] = {
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18, 1.1157877678025181e-17,
    -1.333171662854621e-16, 2.0972767875968562e-17, 6.637638134358324e-15, -4.054566272975207e-14,
    -8.151934197605472e-14, 2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
    1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08, 4.2347877827932404e-07,
    -1.3654692000834679e-06, -1.3882523362786469e-05, 0.00018673420803405714, -0.000740702534166267,
    -0.006033670871430149, 0.24015818242558962, 1.6536545626831027};
__constant__ double kErfInvB64[19] = {
    2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07, 1.8239629214389228e-08,
    1.5027403968909828e-06, -4.013867526981546e-06, 2.9234449089955446e-06, 1.2475304481671779e-05,
    -4.7318229009055734e-05, 6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
    0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851, -0.003751208507569241,
    0.005370914553590064, 1.0052589676941592, 3.0838856104922208};
__constant__ double kErfInvC64[17] = {
    -2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09, -3.789465440126737e-09,
    7.61570120807834e-09, -1.496002662714924e-08, 2.914795345090108e-08, -6.771199775845234e-08,
    2.2900482228026655e-07, -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
    7.599527703001776e-05, -0.00021503011930044477, -0.00013871931833623122, 1.0103004648645344,
    4.849906401408584};
__constant__ double kLog1pNum[7] = {
    4.52700008624452e-05, 0.49854102823193375, 6.578732594206104, 29.911919328553072,
    60.94966798098779, 57.11296359058554, 20.039553499201283};
__constant__ double kLog1pDen[7] = {
    1.0, 15.062909083469192, 83.04756596796722, 221.76239823732857,
    309.09872225312057, 216.42788614495947, 60.11866049760384};
__constant__ double kLogf[9] = {
    0.070376836292, -0.1151461031, 0.1167699874, -0.12420140846,
    0.14249322787, -0.16668057665, 0.20000714765, -0.24999993993,
    0.33333331174};
constexpr double kLog1pSmall = 0.41421356237309503;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return __fma_rn(a, b, c); }

// prng._horner: fma(t, c0, c1), then p = fma(p, t, c_k)
template <typename T>
__device__ T horner(const double* c, int n, T t) {
  T p = fma_t(t, (T)c[0], (T)c[1]);
  for (int k = 2; k < n; ++k) p = fma_t(p, t, (T)c[k]);
  return p;
}

// prng._logf: XLA's float32 log of y (Cephes' logf)
__device__ float logf_xla(float y) {
  const float tiny = 1.17549435e-38f;  // 2**-126, torch.clamp's bound
  const float clamped = y < tiny ? tiny : y;
  const int bits = __float_as_int(clamped);
  float e = __fadd_rn((float)((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const bool low = m < (float)0.707106769;
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float x = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float z = __fmul_rn(x, x);
  const float z3 = __fmul_rn(z, x);
  const float a = fma_t(fma_t(x, (float)kLogf[0], (float)kLogf[1]), x, (float)kLogf[2]);
  const float b = fma_t(fma_t(x, (float)kLogf[3], (float)kLogf[4]), x, (float)kLogf[5]);
  const float c = fma_t(fma_t(x, (float)kLogf[6], (float)kLogf[7]), x, (float)kLogf[8]);
  const float r = fma_t(fma_t(fma_t(a, z3, b), z3, c), z3, __fmul_rn(e, (float)-2.12194440e-4));
  float out = fma_t(e, (float)0.693359375, __fadd_rn(fma_t(-z, 0.5f, x), r));
  if (y <= 0.0f) out = __int_as_float(0x7FC00000);
  if (y == 0.0f) out = -INFINITY;
  if (y == INFINITY) out = y;
  return out;
}

__device__ __forceinline__ float log_large(float y) { return logf_xla(y); }
__device__ __forceinline__ double log_large(double y) { return log(y); }
__device__ __forceinline__ float div_t(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_t(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_t(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_t(double a) { return __dsqrt_rn(a); }

// prng.xla_log1p
template <typename T>
__device__ T log1p_xla(T x) {
  const T x2 = x * x;
  const T num = horner(kLog1pNum, 7, x);
  const T den = horner(kLog1pDen, 7, x);
  const T small = x + fma_t(x2, (T)-0.5, (x * x2) * div_t(num, den));
  const T large = log_large(x + (T)1.0);
  return fabs(x) < (T)kLog1pSmall ? small : large;
}

// prng.erf_inv
__device__ float erf_inv(float x) {
  const float w = -log1p_xla(-x * x);
  const float root = sqrt_t(w);
  const float p = w < 5.0f ? horner(kErfInvA32, 9, w - 2.5f) : horner(kErfInvB32, 9, root - 3.0f);
  return fabsf(x) == 1.0f ? x * INFINITY : p * x;
}

__device__ double erf_inv(double x) {
  const double w = -log1p_xla(-x * x);
  const double root = sqrt_t(w);
  double p = horner(kErfInvC64, 17, root - 5.0);
  if (w < 16.0) p = horner(kErfInvB64, 19, root - 3.25);
  if (w < 6.25) p = horner(kErfInvA64, 23, w - 3.125);
  return fabs(x) == 1.0 ? x * INFINITY : p * x;
}

// prng._unit and uniform's bounds: [nextafter(-1, 0), 1)
__device__ float uniform_from_words(uint32_t t0, uint32_t t1, float) {
  const float unit = __int_as_float(((t0 ^ t1) >> 9) | 0x3F800000u) - 1.0f;
  const float lo = __int_as_float(0xBF7FFFFF);  // nextafter(-1, 0)
  return fmaxf(lo, fma_t(unit, 1.0f - lo, lo));
}

__device__ double uniform_from_words(uint32_t t0, uint32_t t1, double) {
  const uint64_t mant = ((uint64_t)t0 << 20) | ((uint64_t)t1 >> 12);
  const double unit = __longlong_as_double((long long)(mant | 0x3FF0000000000000ull)) - 1.0;
  const double lo = __longlong_as_double(0xBFEFFFFFFFFFFFFFll);  // nextafter(-1, 0)
  return fmax(lo, fma_t(unit, 1.0 - lo, lo));
}

template <typename T>
__global__ void normal_kernel(const int64_t* w0, const int64_t* w1, T* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T u = uniform_from_words((uint32_t)w0[i], (uint32_t)w1[i], T(0));
  out[i] = (T)1.4142135623730951 * erf_inv(u);
}

}  // namespace

// n normals from the threefry words of each (prng._words), float32 (f64 == 0)
// or float64 (f64 == 1) into out: one launch
extern "C" int bjt_normal(const int64_t* w0, const int64_t* w1, void* out, int n, int f64,
                          void* stream) {
  if (n <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    normal_kernel<double><<<(n + 255) / 256, 256, 0, s>>>(w0, w1, static_cast<double*>(out), n);
  } else {
    normal_kernel<float><<<(n + 255) / 256, 256, 0, s>>>(w0, w1, static_cast<float*>(out), n);
  }
  return cudaGetLastError();
}
