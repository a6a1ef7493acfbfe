// K3 (hit resolve + shadow setup) and K4 (Phong + Whitted blend + bounce).
//
// K3 replaces myraytracer_tpu/ops/pallas_shade.py:_pre_kernel (its
// triangle, untextured branch); K4 replaces _phong_kernel (its untextured
// branch). Both are one thread per ray.
//
// K3 reads the hit triangle's tri_pack row by id itself (the reference
// gathers rows outside its kernel), re-solves the barycentrics, picks the
// flat or the unnormalized Phong normal, re-projects the hit point onto
// the triangle plane, takes the material id from column 26, and writes the
// shadow-ray batch light-major: origin p + 1e-4 l, direction l, distance,
// and active = valid & live & shadowable & facing.
//
// K4 adds ambient plus per-light diffuse and specular under the shadow
// mask (specular as exp(shininess * log(base)), the reference's form),
// then the Whitted blend, the mirror-bounce ray and its weight.
//
// Bound on the H100: memory. Each ray reads and writes a few dozen bytes
// for ~100-200 FLOP, and the tri_pack row gather (192 bytes of scattered
// reads per ray) dominates K3. The design keeps the whole per-ray chain in
// registers (one pass instead of the dozens of elementwise launches of the
// plain version) and reads the small material and light tables through
// the read-only cache.
#include "common.cuh"

namespace {

constexpr int KIND_TRI = 3;

__device__ __forceinline__ float mat_at(const float* __restrict__ mat16, int Mt,
                                        int mid, int col) {
  return (mid >= 0 && mid < Mt) ? __ldg(mat16 + mid * 16 + col) : 0.0f;
}

__global__ void shade_pre_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t, const int* __restrict__ kind,
    const int* __restrict__ live, const int* __restrict__ tri_idx,
    const float* __restrict__ tri_pack, int pack_w,
    const float* __restrict__ lp, const float* __restrict__ mat16, int Mt, int L,
    int R, float* __restrict__ point, float* __restrict__ normal,
    int* __restrict__ mid_out, float4* __restrict__ so, float4* __restrict__ sd,
    float* __restrict__ st, int* __restrict__ sact) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const int kd = kind[r];
  const bool is_live = live[r] > 0;
  const bool valid = kd > 0;
  // misses carry t = INF: o + INF*d would poison the gated lanes
  const float tt = valid ? t[r] : 0.0f;
  const float gx = ox + tt * dx, gy = oy + tt * dy, gz = oz + tt * dz;

  const bool is_t = kd == KIND_TRI;
  const float* row = tri_pack + static_cast<long>(tri_idx[r]) * pack_w;
  const float p0x = row[0], p0y = row[1], p0z = row[2];
  const float p1x = row[3], p1y = row[4], p1z = row[5];
  const float p2x = row[6], p2y = row[7], p2z = row[8];
  const float c1x = p0x - p2x, c1y = p0y - p2y, c1z = p0z - p2z;
  const float c2x = p1x - p2x, c2y = p1y - p2y, c2z = p1z - p2z;
  // N = c1 x c2, w = o x d, k2 = p2 x c2, k1 = c1 x p2
  const float nx = c1y * c2z - c1z * c2y, ny = c1z * c2x - c1x * c2z, nz = c1x * c2y - c1y * c2x;
  const float wx = oy * dz - oz * dy, wy = oz * dx - ox * dz, wz = ox * dy - oy * dx;
  const float k2x = p2y * c2z - p2z * c2y, k2y = p2z * c2x - p2x * c2z, k2z = p2x * c2y - p2y * c2x;
  const float k1x = c1y * p2z - c1z * p2y, k1y = c1z * p2x - c1x * p2z, k1z = c1x * p2y - c1y * p2x;

  const float s = -dot3(nx, ny, nz, dx, dy, dz);
  const bool s_ok = fabsf(s) > MRT_EPS_DET;
  const float inv_s = s_ok ? 1.0f / s : 0.0f;
  const float alpha = (dot3(c2x, c2y, c2z, wx, wy, wz) + dot3(k2x, k2y, k2z, dx, dy, dz)) * inv_s;
  const float beta = (-dot3(c1x, c1y, c1z, wx, wy, wz) + dot3(k1x, k1y, k1z, dx, dy, dz)) * inv_s;
  const float gamma = 1.0f - alpha - beta;

  // unit flat normal; Phong normal left unnormalized
  const float inv_n = safe_rsqrt(dot3(nx, ny, nz, nx, ny, nz));
  const float fx = nx * inv_n, fy = ny * inv_n, fz = nz * inv_n;
  const bool phong = row[25] > 0.5f;
  const float tnx = phong ? alpha * row[16] + beta * row[19] + gamma * row[22] : fx;
  const float tny = phong ? alpha * row[17] + beta * row[20] + gamma * row[23] : fy;
  const float tnz = phong ? alpha * row[18] + beta * row[21] + gamma * row[24] : fz;

  // hit point re-projected onto the triangle plane
  const float off = dot3(fx, fy, fz, gx - p2x, gy - p2y, gz - p2z);
  const float px = is_t ? gx - off * fx : gx;
  const float py = is_t ? gy - off * fy : gy;
  const float pz = is_t ? gz - off * fz : gz;
  const float nmx = is_t ? tnx : 0.0f;
  const float nmy = is_t ? tny : 0.0f;
  const float nmz = is_t ? tnz : 0.0f;
  const float midf = is_t ? row[26] : 0.0f;
  const int mid = static_cast<int>(valid ? midf : 0.0f);

  point[3 * r] = px;
  point[3 * r + 1] = py;
  point[3 * r + 2] = pz;
  normal[3 * r] = nmx;
  normal[3 * r + 1] = nmy;
  normal[3 * r + 2] = nmz;
  mid_out[r] = mid;

  const bool cast = valid && is_live && (mat_at(mat16, Mt, mid, 11) > 0.5f);
  for (int li = 0; li < L; ++li) {
    const float lvx = __ldg(lp + 3 * li) - px;
    const float lvy = __ldg(lp + 3 * li + 1) - py;
    const float lvz = __ldg(lp + 3 * li + 2) - pz;
    const float dist2 = dot3(lvx, lvy, lvz, lvx, lvy, lvz);
    const float dist = sqrtf(dist2);
    const float inv = safe_rsqrt(dist2);
    const float ldx = lvx * inv, ldy = lvy * inv, ldz = lvz * inv;
    const bool facing = dot3(nmx, nmy, nmz, ldx, ldy, ldz) > 0.0f;
    const long q = static_cast<long>(li) * R + r;
    so[q] = make_float4(px + MRT_EPS_OFFSET * ldx, py + MRT_EPS_OFFSET * ldy,
                        pz + MRT_EPS_OFFSET * ldz, 0.0f);
    sd[q] = make_float4(ldx, ldy, ldz, 1.0f);
    st[q] = dist;
    sact[q] = (cast && facing) ? 1 : 0;
  }
}

__global__ void shade_phong_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ weight, const int* __restrict__ valid_in,
    const int* __restrict__ live_in, const int* __restrict__ mid_in,
    const float* __restrict__ point, const float* __restrict__ normal,
    const int* __restrict__ shadow, const float* __restrict__ lp,
    const float* __restrict__ lc, const float* __restrict__ env,
    const float* __restrict__ mat16, int Mt, int L, int R,
    float* __restrict__ add, float* __restrict__ o2, float* __restrict__ d2,
    float* __restrict__ w2) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float w = weight[r];
  const bool valid = valid_in[r] > 0;
  const bool is_live = live_in[r] > 0;
  const float px = point[3 * r], py = point[3 * r + 1], pz = point[3 * r + 2];
  const float nmx = normal[3 * r], nmy = normal[3 * r + 1], nmz = normal[3 * r + 2];
  const int mid = mid_in[r];

  const float kdx = mat_at(mat16, Mt, mid, 0), kdy = mat_at(mat16, Mt, mid, 1),
              kdz = mat_at(mat16, Mt, mid, 2);
  const float kax = mat_at(mat16, Mt, mid, 3), kay = mat_at(mat16, Mt, mid, 4),
              kaz = mat_at(mat16, Mt, mid, 5);
  const float ksx = mat_at(mat16, Mt, mid, 6), ksy = mat_at(mat16, Mt, mid, 7),
              ksz = mat_at(mat16, Mt, mid, 8);
  const float shin = mat_at(mat16, Mt, mid, 9);
  const float mirror = valid ? mat_at(mat16, Mt, mid, 10) : 0.0f;

  float cr = __ldg(env) * kax;
  float cg = __ldg(env + 1) * kay;
  float cb = __ldg(env + 2) * kaz;
  for (int li = 0; li < L; ++li) {
    const float lvx = __ldg(lp + 3 * li) - px;
    const float lvy = __ldg(lp + 3 * li + 1) - py;
    const float lvz = __ldg(lp + 3 * li + 2) - pz;
    const float inv = safe_rsqrt(dot3(lvx, lvy, lvz, lvx, lvy, lvz));
    const float ldx = lvx * inv, ldy = lvy * inv, ldz = lvz * inv;
    const float diff = nmax(0.0f, dot3(nmx, nmy, nmz, ldx, ldy, ldz));
    // specular: r = 2 (l.n) n - l, against the raw view -d
    const float ln = dot3(ldx, ldy, ldz, nmx, nmy, nmz);
    const float rx = 2.0f * ln * nmx - ldx;
    const float ry = 2.0f * ln * nmy - ldy;
    const float rz = 2.0f * ln * nmz - ldz;
    const float rinv = safe_rsqrt(dot3(rx, ry, rz, rx, ry, rz));
    const float cos_rv = nmax(0.0f, -dot3(rx, ry, rz, dx, dy, dz) * rinv);
    const bool gate = (diff > 0.0f) && (cos_rv > 0.0f);
    const float base = gate ? cos_rv : 1.0f;
    const float spec = gate ? expf(shin * logf(base)) : 0.0f;
    const float lit = 1.0f - static_cast<float>(shadow[static_cast<long>(li) * R + r]);
    cr = cr + __ldg(lc + 3 * li) * lit * (kdx * diff + ksx * spec);
    cg = cg + __ldg(lc + 3 * li + 1) * lit * (kdy * diff + ksy * spec);
    cb = cb + __ldg(lc + 3 * li + 2) * lit * (kdz * diff + ksz * spec);
  }

  const bool h = is_live && valid;
  const bool miss = is_live && !valid;
  const float wf = w * (1.0f - mirror);
  const float hf = h ? 1.0f : 0.0f;
  const float mf = miss ? 1.0f : 0.0f;
  add[3 * r] = hf * wf * cr + mf * w * __ldg(env + 3);
  add[3 * r + 1] = hf * wf * cg + mf * w * __ldg(env + 4);
  add[3 * r + 2] = hf * wf * cb + mf * w * __ldg(env + 5);

  // mirror bounce with the raw shading normal: d - 2 (d.n) n
  const float dn = dot3(dx, dy, dz, nmx, nmy, nmz);
  const float rfx = dx - 2.0f * dn * nmx;
  const float rfy = dy - 2.0f * dn * nmy;
  const float rfz = dz - 2.0f * dn * nmz;
  o2[3 * r] = h ? px + MRT_EPS_OFFSET * rfx : o[3 * r];
  o2[3 * r + 1] = h ? py + MRT_EPS_OFFSET * rfy : o[3 * r + 1];
  o2[3 * r + 2] = h ? pz + MRT_EPS_OFFSET * rfz : o[3 * r + 2];
  d2[3 * r] = h ? rfx : dx;
  d2[3 * r + 1] = h ? rfy : dy;
  d2[3 * r + 2] = h ? rfz : dz;
  w2[r] = h ? w * mirror : 0.0f;
}

constexpr int kThreads = 256;

}  // namespace

// o, d [R, 3]; t, kind, live, tri_idx [R]; tri_pack [T, pack_w]; lp [L, 3];
// mat16 [Mt, 16]. Outputs: point, normal [R, 3]; mid [R];
// so, sd [L*R, 4]; st, sact [L*R] (light-major).
extern "C" int mrt_shade_pre(const void* o, const void* d, const void* t,
                             const void* kind, const void* live,
                             const void* tri_idx, const void* tri_pack,
                             int pack_w, const void* lp, const void* mat16,
                             int Mt, int L, int R, void* point, void* normal,
                             void* mid, void* so, void* sd, void* st,
                             void* sact, void* stream) {
  const int blocks = (R + kThreads - 1) / kThreads;
  shade_pre_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t), static_cast<const int*>(kind),
      static_cast<const int*>(live), static_cast<const int*>(tri_idx),
      static_cast<const float*>(tri_pack), pack_w,
      static_cast<const float*>(lp), static_cast<const float*>(mat16), Mt, L, R,
      static_cast<float*>(point), static_cast<float*>(normal),
      static_cast<int*>(mid), static_cast<float4*>(so), static_cast<float4*>(sd),
      static_cast<float*>(st), static_cast<int*>(sact));
  return static_cast<int>(cudaGetLastError());
}

// o, d, point, normal [R, 3]; weight, valid, live, mid [R]; shadow [L*R]
// (light-major); lp, lc [L, 3]; env [6] (ambience, background);
// mat16 [Mt, 16]. Outputs: add, o2, d2 [R, 3]; w2 [R].
extern "C" int mrt_shade_phong(const void* o, const void* d, const void* weight,
                               const void* valid, const void* live,
                               const void* mid, const void* point,
                               const void* normal, const void* shadow,
                               const void* lp, const void* lc, const void* env,
                               const void* mat16, int Mt, int L, int R,
                               void* add, void* o2, void* d2, void* w2,
                               void* stream) {
  const int blocks = (R + kThreads - 1) / kThreads;
  shade_phong_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(weight), static_cast<const int*>(valid),
      static_cast<const int*>(live), static_cast<const int*>(mid),
      static_cast<const float*>(point), static_cast<const float*>(normal),
      static_cast<const int*>(shadow), static_cast<const float*>(lp),
      static_cast<const float*>(lc), static_cast<const float*>(env),
      static_cast<const float*>(mat16), Mt, L, R, static_cast<float*>(add),
      static_cast<float*>(o2), static_cast<float*>(d2), static_cast<float*>(w2));
  return static_cast<int>(cudaGetLastError());
}
