// Point kernels of the Jacobian windowed MSM (ops/msm.py), G1 over Fq and
// G2 over Fq2, on one cooperative Jacobian add and doubling.
//
// The JAX versions are XLA programs (no Pallas kernel stands behind them):
// ops/msm.py _k_seg_scan_step, _k_bucket_reduce and _k_double8_add over
// ops/curve_ops.py point_add / point_double. Here the MSM is four kinds of
// launch, each holding every add of its part:
//
//   jac_scan_kernel    one Hillis-Steele step of the segmented scan: lane i
//                      of a window row adds lane i - offset unless its run
//                      starts within reach (i - runstart(i) < offset, the
//                      keep mask of ops/msm.py, read from one int32 run
//                      position a lane); src and dst are two buffers
//   jac_reduce_kernel  the bucket reduction of a window, all 510 dependent
//                      adds (running += S_d; total += running, d = 255..1),
//                      S_d read from the scan buffer at the end of digit
//                      d's run through a (W, 256) lane table, -1 for empty
//   jac_horner_kernel  acc = T[W-1]; acc = 2^8 acc + T[w] for w = W-2..0
//   jac_add_kernel     p + q over a batch (the sharded MSM's combine)
//
// What bounds them on an H100: integer multiplies and, on the chains,
// their latency. A general add is 16 products (Fq for G1, Fq2 = 3 Fq
// Karatsuba products for G2), a doubling 7, 264 multiply instructions an
// Fq product (field.cuh), and a product is one chain of carry-dependent
// instructions: a thread alone cannot interleave two. So a scan step
// (2^20 independent lanes at 2^16 points) is bound by how many products
// are in flight on an SM, which the registers of a thread that holds
// whole points cap (G2: 255 registers and spills, 8 warps an SM); the
// reduction and Horner are one chain of dependent adds per window.
//
// The design: a team of TEAM threads shares one add through shared
// memory, in stages of independent products:
//   add-2007-bl   P1  Z1^2, Z2^2, Y1 Z2, Y2 Z1, Z1 Z2
//                 P2  U1 = X1 Z2^2, U2 = X2 Z1^2, S1, S2
//                 L2  H = U2 - U1, 2H, r = 2 (S2 - S1); the dispatch flags
//                 P3  I = (2H)^2, r^2, Z3 = 2H Z1 Z2
//                 P4  J = H I, V = U1 I
//                 L4  X3 = r^2 - J - 2V, V - X3
//                 P5  r (V - X3), S1 J
//                 L5  Y3 = r (V - X3) - 2 S1 J, or the other cases' result
//   dbl-2009-l    P1  X^2, Y^2, Y Z;  L1  X + B, E = 3A, Z3 = 2 Y Z
//                 P2  C = B^2, (X + B)^2, E^2;  L2  D, X3 = E^2 - 2D, D - X3
//                 P3  E (D - X3);  L3  Y3 = E (D - X3) - 8C
// A product stage's units (G1: a product; G2: one of its three Karatsuba
// products, t0 = a0 b0, t1 = a1 b1, s = (a0 + a1)(b0 + b1), then settled
// in place as (t0 - t1, s - t0 - t1, s - 2 t1), the product and the sum of
// its components, behind one more barrier) go round robin to the team's
// members; a linear stage is one thread a coordinate component. A thread
// holds one product's operands, not two points. The scan's teams are small
// (G1 one thread, G2 six: at most three Karatsuba products a member a
// stage), the chains' wide (G1 five, G2 fifteen: one product a member a
// stage, so an add is five product latencies).
//
// Bit-equal to the plain versions (ops/curve_ops.py point_add,
// point_double): every field operation returns the canonical residue, so
// each coordinate is the same field element as the formulas' in one
// thread, word for word. The dispatch is point_add's, in its order: q at
// infinity gives p, else p at infinity gives q, else H = 0 gives the
// doubling of p (S1 = S2) or (0 : one : 0) (S1 != S2), else the sum. The
// doubling has no dispatch (point_double's formulas on any input). Every
// thread of a block reaches every barrier: an add that is off, or in
// another case, skips a stage's work but not its barrier, and a block runs
// the doubling's stages only when one of its adds needs them
// (__syncthreads_or).
//
// Shared memory: an add's slots are Fq elements, words-first across the
// block's A adds (word k of element f of add a at sm[(f * 8 + k) * A + a]),
// so a warp of one member over 32 adds reads 32 banks. Slots 0-2 hold p
// (the result lands there), 3-5 q, 6-14 the stages' values (G2: two Fq an
// input slot, three a work slot).
// Point words of a (C, ld) buffer, rows X | Y | Z (G2: X.c0, X.c1, Y.c0,
// ...), map onto slots 0-5 row for row.
//
// Team sizes and adds a block are constants chosen on the card (PERF.md;
// tools/jac_teams.py builds copies of this file with other values and
// times them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libjac_kernels.so jac_kernels.cu

#include <atomic>

#include "field.cuh"

constexpr int SCAN_ADDS = 32;  // adds a block of the scan and batch add
static_assert(SCAN_ADDS % 32 == 0, "SCAN_ADDS: whole warps");

// PARTS: Karatsuba products of a T product; COMPS: Fq components of a T;
// NF: Fq slots of an add; SCAN / CHAIN: team sizes of the scan and batch
// add / of the reduction and Horner
template <class T>
struct Team;

template <>
struct Team<Fq> {
    static constexpr int PARTS = 1, COMPS = 1, NF = 15;
    static constexpr int SCAN = 1, CHAIN = 5;
};

template <>
struct Team<Fq2> {
    static constexpr int PARTS = 3, COMPS = 2, NF = 6 * 2 + 9 * 3;
    static constexpr int SCAN = 6, CHAIN = 15;
};

// a linear stage is a thread a component: a team holds them all
template <class T>
constexpr bool team_ok() {
    return Team<T>::SCAN >= Team<T>::COMPS && Team<T>::CHAIN >= Team<T>::COMPS;
}
static_assert(team_ok<Fq>() && team_ok<Fq2>(),
              "a team has at least a coordinate's components");

constexpr int PROD = 32;  // a slot code's flag: a product stage wrote it
constexpr int NBUCKETS = 256;

// Fq element of component or Karatsuba part k of slot s
template <class T>
__device__ __forceinline__ int fslot(int s, int k) {
    if (Team<T>::PARTS == 1) return s;
    return s < 6 ? 2 * s + k : 12 + 3 * (s - 6) + k;
}

template <int A>
__device__ __forceinline__ Fq sld(const u32* sm, int f, int a) {
    Fq r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.w[k] = sm[(f * 8 + k) * A + a];
    return r;
}

template <int A>
__device__ __forceinline__ void sst(u32* sm, int f, int a, const Fq& v) {
#pragma unroll
    for (int k = 0; k < 8; ++k) sm[(f * 8 + k) * A + a] = v.w[k];
}

// component c of the value in slot `code`
template <class T, int A>
__device__ __forceinline__ Fq comp(const u32* sm, int code, int c, int a) {
    return sld<A>(sm, fslot<T>(code & (PROD - 1), c), a);
}

// operand of Karatsuba part k: component k, or c0 + c1 for k = 2, which a
// product's slot holds as its third element
template <class T, int A>
__device__ __forceinline__ Fq part(const u32* sm, int code, int k, int a) {
    if (k < 2 || (code & PROD)) return comp<T, A>(sm, code, k, a);
    return add(comp<T, A>(sm, code, 0, a), comp<T, A>(sm, code, 1, a));
}

__device__ __forceinline__ bool is_zero(const Fq& a) {
    u32 o = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) o |= a.w[j];
    return o == 0;
}

struct Prod {
    unsigned char o, x, y;  // slot o = slot x times slot y
};

// the stages' products (slot codes; see the stage list above)
__constant__ Prod kAddP1[5] = {{6, 2, 2}, {7, 5, 5}, {8, 1, 5}, {9, 4, 2},
                               {10, 2, 5}};
__constant__ Prod kAddP2[4] = {{11, 0, 7 | PROD}, {12, 3, 6 | PROD},
                               {13, 8 | PROD, 7 | PROD}, {14, 9 | PROD, 6 | PROD}};
__constant__ Prod kAddP3[3] = {{9, 7, 7}, {12, 8, 8}, {14, 7, 10 | PROD}};
__constant__ Prod kAddP4[2] = {{7, 6, 9 | PROD}, {10, 11 | PROD, 9 | PROD}};
__constant__ Prod kAddP5[2] = {{11, 8, 9}, {12, 13 | PROD, 7 | PROD}};
__constant__ Prod kDblP1[3] = {{6, 0, 0}, {7, 1, 1}, {8, 1, 2}};
__constant__ Prod kDblP2[3] = {{11, 7 | PROD, 7 | PROD}, {12, 9, 9},
                               {13, 10, 10}};
__constant__ Prod kDblP3[1] = {{6, 10, 9}};

// One product stage: member j takes units j, j + TEAM, ... of the adds
// that are on. G2 writes the Karatsuba products t0, t1, s of a product
// into its slot and, behind a barrier, settles them in place as (c0, c1,
// c0 + c1) = (t0 - t1, s - t0 - t1, s - 2 t1), a thread a product, so that
// later stages read them with no arithmetic. Every thread reaches the
// closing barrier, which returns the block's OR of `pred`.
template <class T, int A, int TEAM, int N>
__device__ __forceinline__ int products(u32* sm, const Prod (&tab)[N], int a,
                                        int j, bool on, int pred = 0) {
    constexpr int P = Team<T>::PARTS;
    if (on) {
        for (int u = j; u < N * P; u += TEAM) {
            const Prod op = tab[u / P];
            const int k = u % P;
            const Fq x = part<T, A>(sm, op.x, k, a);
            const Fq y = op.y == op.x ? x : part<T, A>(sm, op.y, k, a);
            sst<A>(sm, fslot<T>(op.o, k), a, mul(x, y));
        }
    }
    if (P == 1) return __syncthreads_or(pred);
    __syncthreads();
    if (on) {
        for (int i = j; i < N; i += TEAM) {
            const int f = fslot<T>(tab[i].o, 0);
            const Fq t0 = sld<A>(sm, f, a), t1 = sld<A>(sm, f + 1, a);
            const Fq st = sub(sld<A>(sm, f + 2, a), t1);  // s - t1
            sst<A>(sm, f, a, sub(t0, t1));
            sst<A>(sm, f + 1, a, sub(st, t0));
            sst<A>(sm, f + 2, a, sub(st, t1));
        }
    }
    return __syncthreads_or(pred);
}

// dbl-2009-l (a = 0) of p in slots 0-2, in place; point_double's formulas
template <class T, int A, int TEAM>
__device__ __forceinline__ void team_dbl(u32* sm, int a, int j, bool on) {
    constexpr int NC = Team<T>::COMPS;
    products<T, A, TEAM>(sm, kDblP1, a, j, on);  // A 6, B 7, YZ 8
    if (on && j < NC) {
        const Fq X = comp<T, A>(sm, 0, j, a);
        const Fq A_ = comp<T, A>(sm, 6 | PROD, j, a);
        const Fq B = comp<T, A>(sm, 7 | PROD, j, a);
        const Fq YZ = comp<T, A>(sm, 8 | PROD, j, a);
        sst<A>(sm, fslot<T>(9, j), a, add(X, B));           // X + B
        sst<A>(sm, fslot<T>(10, j), a, add(add(A_, A_), A_));  // E = 3A
        sst<A>(sm, fslot<T>(2, j), a, add(YZ, YZ));         // Z3 = 2 Y Z
    }
    __syncthreads();
    products<T, A, TEAM>(sm, kDblP2, a, j, on);  // C 11, (X + B)^2 12, E^2 13
    if (on && j < NC) {
        const Fq A_ = comp<T, A>(sm, 6 | PROD, j, a);
        const Fq C = comp<T, A>(sm, 11 | PROD, j, a);
        Fq D = sub(sub(comp<T, A>(sm, 12 | PROD, j, a), A_), C);
        D = add(D, D);
        const Fq X3 = sub(comp<T, A>(sm, 13 | PROD, j, a), add(D, D));
        sst<A>(sm, fslot<T>(0, j), a, X3);
        sst<A>(sm, fslot<T>(9, j), a, sub(D, X3));  // D - X3
    }
    __syncthreads();
    products<T, A, TEAM>(sm, kDblP3, a, j, on);  // E (D - X3) 6
    if (on && j < NC) {
        Fq C8 = comp<T, A>(sm, 11 | PROD, j, a);
        C8 = add(C8, C8);
        C8 = add(C8, C8);
        C8 = add(C8, C8);
        sst<A>(sm, fslot<T>(1, j), a, sub(comp<T, A>(sm, 6 | PROD, j, a), C8));
    }
    __syncthreads();
}

enum { GENERAL, Q_INF, P_INF, DOUBLE, IDENTITY, OFF };

// add-2007-bl with point_add's dispatch: slots 0-2 = p + q; flg holds
// COMPS x A ints. The inputs must be in place before the call (behind a
// barrier); the result is behind one when it returns.
template <class T, int A, int TEAM>
__device__ __forceinline__ void team_add(u32* sm, int* flg, int a, int j,
                                         bool on) {
    constexpr int NC = Team<T>::COMPS;
    products<T, A, TEAM>(sm, kAddP1, a, j, on);
    products<T, A, TEAM>(sm, kAddP2, a, j, on);
    if (on && j < NC) {  // L2 and the dispatch's zero tests
        const Fq U1 = comp<T, A>(sm, 11 | PROD, j, a);
        const Fq H = sub(comp<T, A>(sm, 12 | PROD, j, a), U1);
        Fq R = sub(comp<T, A>(sm, 14 | PROD, j, a),
                   comp<T, A>(sm, 13 | PROD, j, a));
        R = add(R, R);
        sst<A>(sm, fslot<T>(6, j), a, H);
        sst<A>(sm, fslot<T>(7, j), a, add(H, H));
        sst<A>(sm, fslot<T>(8, j), a, R);
        flg[j * A + a] = is_zero(H) | is_zero(R) << 1
                         | is_zero(sld<A>(sm, fslot<T>(2, j), a)) << 2
                         | is_zero(sld<A>(sm, fslot<T>(5, j), a)) << 3;
    }
    __syncthreads();
    int cs = OFF;
    if (on) {
        int b = flg[a];
        if (NC == 2) b &= flg[A + a];
        cs = b & 8   ? Q_INF
             : b & 4 ? P_INF
             : b & 1 ? (b & 2 ? DOUBLE : IDENTITY)
                     : GENERAL;
    }
    const bool gen = cs == GENERAL;
    const int dbl_any = products<T, A, TEAM>(sm, kAddP3, a, j, gen,
                                             cs == DOUBLE);
    products<T, A, TEAM>(sm, kAddP4, a, j, gen);
    if (gen && j < NC) {  // L4
        const Fq V = comp<T, A>(sm, 10 | PROD, j, a);
        const Fq X3 = sub(sub(comp<T, A>(sm, 12 | PROD, j, a),
                              comp<T, A>(sm, 7 | PROD, j, a)),
                          add(V, V));
        sst<A>(sm, fslot<T>(0, j), a, X3);
        sst<A>(sm, fslot<T>(9, j), a, sub(V, X3));
    }
    __syncthreads();
    products<T, A, TEAM>(sm, kAddP5, a, j, gen);
    if (j < NC) {  // L5, and the results of the other cases
        if (gen) {
            const Fq B = comp<T, A>(sm, 12 | PROD, j, a);
            sst<A>(sm, fslot<T>(1, j), a,
                   sub(comp<T, A>(sm, 11 | PROD, j, a), add(B, B)));
            sst<A>(sm, fslot<T>(2, j), a, comp<T, A>(sm, 14 | PROD, j, a));
        } else if (cs == P_INF) {
            for (int s = 0; s < 3; ++s)
                sst<A>(sm, fslot<T>(s, j), a, comp<T, A>(sm, s + 3, j, a));
        } else if (cs == IDENTITY) {
            const Fq z = Coord<Fq>::zero();
            sst<A>(sm, fslot<T>(0, j), a, z);
            sst<A>(sm, fslot<T>(1, j), a, j == 0 ? Coord<Fq>::one() : z);
            sst<A>(sm, fslot<T>(2, j), a, z);
        }
    }
    __syncthreads();
    if (dbl_any) team_dbl<T, A, TEAM>(sm, a, j, cs == DOUBLE);
}

// word w of the identity (0 : one : 0)
template <class T>
__device__ __forceinline__ u32 ident_word(int w) {
    constexpr int K = Coord<T>::ROWS;
    return w >= K && w < K + 8 ? kOne[0][w - K] : 0u;
}

template <class T, int A>
constexpr int team_smem() {  // bytes: the slots and the flags
    return (Team<T>::NF * 8 * A + Team<T>::COMPS * A) * 4;
}

// ---------------------------------------------------------------------------
// the launches
// ---------------------------------------------------------------------------

// One scan step over L = rows x n lanes of (C, L) words. Lanes with pos >=
// offset add (p = lane, q = lane - offset, the same row since pos <= the
// lane's index in its row); lanes with offset / 2 <= pos < offset were
// added into src by the step before and are copied; lanes with pos <
// offset / 2 are final since an earlier step and already equal in both
// buffers, so they are not written (pos -1, digit 0's lanes, which no add
// reads: never written).
template <class T>
__global__ void __launch_bounds__(SCAN_ADDS * Team<T>::SCAN)
    jac_scan_kernel(const u32* __restrict__ src, u32* __restrict__ dst,
                    const int* __restrict__ pos, long L, int offset) {
    extern __shared__ u32 sm[];
    constexpr int A = SCAN_ADDS, TEAM = Team<T>::SCAN;
    constexpr int C = 3 * Coord<T>::ROWS;
    int* flg = (int*)(sm + Team<T>::NF * 8 * A);
    const int a = threadIdx.x % A, j = threadIdx.x / A;
    const long i = (long)blockIdx.x * A + a;
    const int ps = i < L ? pos[i] : -1;
    const bool on = ps >= offset;
    if (!on && ps >= offset >> 1)
        for (int w = j; w < C; w += TEAM) dst[w * L + i] = src[w * L + i];
    if (!__syncthreads_or(on)) return;
    if (on)
        for (int w = j; w < C; w += TEAM) {
            sm[w * A + a] = src[w * L + i];
            sm[(C + w) * A + a] = src[w * L + i - offset];
        }
    __syncthreads();
    team_add<T, A, TEAM>(sm, flg, a, j, on);
    if (on)
        for (int w = j; w < C; w += TEAM) dst[w * L + i] = sm[w * A + a];
}

// p + q of each column of two batches; out (C, n) contiguous
template <class T>
__global__ void __launch_bounds__(SCAN_ADDS * Team<T>::SCAN)
    jac_add_kernel(const u32* __restrict__ p, long ldp,
                   const u32* __restrict__ q, long ldq, u32* __restrict__ out,
                   long n) {
    extern __shared__ u32 sm[];
    constexpr int A = SCAN_ADDS, TEAM = Team<T>::SCAN;
    constexpr int C = 3 * Coord<T>::ROWS;
    int* flg = (int*)(sm + Team<T>::NF * 8 * A);
    const int a = threadIdx.x % A, j = threadIdx.x / A;
    const long i = (long)blockIdx.x * A + a;
    const bool on = i < n;
    if (on)
        for (int w = j; w < C; w += TEAM) {
            sm[w * A + a] = p[w * ldp + i];
            sm[(C + w) * A + a] = q[w * ldq + i];
        }
    __syncthreads();
    team_add<T, A, TEAM>(sm, flg, a, j, on);
    if (on)
        for (int w = j; w < C; w += TEAM) out[w * n + i] = sm[w * A + a];
}

// The bucket reduction of window blockIdx.x: two adds a step, running +=
// S_d (add 0) beside total += running of the step before (add 1), d =
// 255..1, then the last total add: 510 adds, each of point_add's operands
// as ops/msm.py's loop gives them. vals (C, L) words; ends (windows, 256)
// lanes; out column blockIdx.x of (C, ldo) words.
template <class T>
__global__ void __launch_bounds__(2 * Team<T>::CHAIN)
    jac_reduce_kernel(const u32* __restrict__ vals, long L,
                      const int* __restrict__ ends, u32* __restrict__ out,
                      long ldo) {
    extern __shared__ u32 sm[];
    constexpr int A = 2, TEAM = Team<T>::CHAIN, NT = A * TEAM;
    constexpr int C = 3 * Coord<T>::ROWS;
    u32* bk = sm + Team<T>::NF * 8 * A;  // (C, 256) words: S_d in column d
    int* flg = (int*)(bk + C * NBUCKETS);
    const int t = threadIdx.x, a = t % A, j = t / A;
    const int* e = ends + (long)blockIdx.x * NBUCKETS;
    for (int x = t; x < C * NBUCKETS; x += NT) {
        const int w = x / NBUCKETS, d = x % NBUCKETS;
        bk[x] = e[d] >= 0 ? vals[w * L + e[d]] : 0u;  // empty: zeros, Z = 0
    }
    for (int x = t; x < 2 * C; x += NT)  // running and total: (0 : one : 0)
        sm[(x % C) * A + x / C] = ident_word<T>(x % C);
    for (int d = NBUCKETS - 1; d >= 0; --d) {
        __syncthreads();
        for (int x = t; x < 2 * C; x += NT) {
            if (x < C)
                sm[(C + x) * A] = bk[x * NBUCKETS + d];  // q of add 0: S_d
            else
                sm[x * A + 1] = sm[(x - C) * A];  // q of add 1: running
        }
        __syncthreads();
        team_add<T, A, TEAM>(sm, flg, a, j,
                             a == 0 ? d >= 1 : d < NBUCKETS - 1);
    }
    for (int w = t; w < C; w += NT) out[w * ldo + blockIdx.x] = sm[w * A + 1];
}

// Horner over the window totals (C, ld) words, columns 0..windows-1, on
// one team: out (C, 1) = sum_w 2^(8 w) T[w], eight doublings and an add a
// window, high to low.
template <class T>
__global__ void __launch_bounds__(Team<T>::CHAIN)
    jac_horner_kernel(const u32* __restrict__ tot, long ld, int windows,
                      u32* __restrict__ out) {
    extern __shared__ u32 sm[];
    constexpr int A = 1, TEAM = Team<T>::CHAIN;
    constexpr int C = 3 * Coord<T>::ROWS;
    u32* ts = sm + Team<T>::NF * 8;  // (C, windows) totals
    int* flg = (int*)(ts + C * windows);
    const int j = threadIdx.x;
    for (int x = j; x < C * windows; x += TEAM)
        ts[x] = tot[(x / windows) * ld + x % windows];
    __syncthreads();
    for (int w = j; w < C; w += TEAM) sm[w] = ts[w * windows + windows - 1];
    for (int k = windows - 2; k >= 0; --k) {
        for (int w = j; w < C; w += TEAM) sm[C + w] = ts[w * windows + k];
        __syncthreads();
        for (int r = 0; r < 8; ++r) team_dbl<T, A, TEAM>(sm, 0, j, true);
        team_add<T, A, TEAM>(sm, flg, 0, j, true);
    }
    __syncthreads();
    for (int w = j; w < C; w += TEAM) out[w] = sm[w];
}

// ---------------------------------------------------------------------------
// launchers; curve: 0 = G1, 1 = G2
// ---------------------------------------------------------------------------

// The kernel's dynamic shared memory, and the most shared memory an SM
// can have beside L1 (the scan's occupancy is its shared memory's): set
// once a kernel and device, `fitted` the devices done, a bit each.
template <class K>
static cudaError_t fit_smem(K kernel, int bytes,
                            std::atomic<unsigned long long>& fitted) {
    int dev = 0;
    if (cudaError_t e = cudaGetDevice(&dev)) return e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (fitted.load() & bit) return cudaSuccess;
    if (cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared))
        return e;
    if (cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))
        return e;
    fitted.fetch_or(bit);
    return cudaSuccess;
}

template <class T>
static int scan_launch(const u32* src, u32* dst, const int* pos, long L,
                       int offset, cudaStream_t s) {
    constexpr int A = SCAN_ADDS, bytes = team_smem<T, A>();
    static std::atomic<unsigned long long> fitted{0};
    if (cudaError_t e = fit_smem(jac_scan_kernel<T>, bytes, fitted))
        return (int)e;
    constexpr int threads = A * Team<T>::SCAN;
    const unsigned blocks = (unsigned)((L + A - 1) / A);
    jac_scan_kernel<T><<<blocks, threads, bytes, s>>>(src, dst, pos, L,
                                                      offset);
    return (int)cudaGetLastError();
}

// src, dst: (C, L) words; pos: (L,) run positions
extern "C" int zt_jac_scan(int curve, const void* src, void* dst,
                           const void* pos, long L, int offset,
                           void* stream) {
    if (L <= 0) return 0;
    if (offset <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const u32* a = (const u32*)src;
    u32* b = (u32*)dst;
    const int* ps = (const int*)pos;
    return curve == 0 ? scan_launch<Fq>(a, b, ps, L, offset, s)
                      : scan_launch<Fq2>(a, b, ps, L, offset, s);
}

template <class T>
static int add_launch(const u32* p, long ldp, const u32* q, long ldq, u32* o,
                      long n, cudaStream_t s) {
    constexpr int A = SCAN_ADDS, bytes = team_smem<T, A>();
    static std::atomic<unsigned long long> fitted{0};
    if (cudaError_t e = fit_smem(jac_add_kernel<T>, bytes, fitted))
        return (int)e;
    constexpr int threads = A * Team<T>::SCAN;
    const unsigned blocks = (unsigned)((n + A - 1) / A);
    jac_add_kernel<T><<<blocks, threads, bytes, s>>>(p, ldp, q, ldq, o, n);
    return (int)cudaGetLastError();
}

// p, q: (C, ld*) words; out: (C, n) words
extern "C" int zt_jac_add(int curve, const void* p, long ldp, const void* q,
                          long ldq, void* out, long n, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const u32* a = (const u32*)p;
    const u32* b = (const u32*)q;
    u32* o = (u32*)out;
    return curve == 0 ? add_launch<Fq>(a, ldp, b, ldq, o, n, s)
                      : add_launch<Fq2>(a, ldp, b, ldq, o, n, s);
}

template <class T>
static int reduce_launch(const u32* vals, long L, const int* ends, int windows,
                         u32* out, long ldo, cudaStream_t s) {
    constexpr int threads = 2 * Team<T>::CHAIN;
    constexpr int bytes = team_smem<T, 2>()
                          + 3 * Coord<T>::ROWS * NBUCKETS * 4;
    static std::atomic<unsigned long long> fitted{0};
    if (cudaError_t e = fit_smem(jac_reduce_kernel<T>, bytes, fitted))
        return (int)e;
    jac_reduce_kernel<T><<<windows, threads, bytes, s>>>(vals, L, ends, out,
                                                         ldo);
    return (int)cudaGetLastError();
}

// vals: (C, L) words; ends: (windows, 256) lanes, -1 empty; out: (C, ldo)
// words, window w into column w
extern "C" int zt_jac_reduce(int curve, const void* vals, long L,
                             const void* ends, int windows, void* out,
                             long ldo, void* stream) {
    if (windows <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const u32* v = (const u32*)vals;
    const int* e = (const int*)ends;
    u32* o = (u32*)out;
    return curve == 0 ? reduce_launch<Fq>(v, L, e, windows, o, ldo, s)
                      : reduce_launch<Fq2>(v, L, e, windows, o, ldo, s);
}

template <class T>
static int horner_launch(const u32* tot, long ld, int windows, u32* out,
                         cudaStream_t s) {
    constexpr int most = team_smem<T, 1>() + 3 * Coord<T>::ROWS * 64 * 4;
    const int bytes = team_smem<T, 1>() + 3 * Coord<T>::ROWS * windows * 4;
    constexpr int threads = Team<T>::CHAIN;
    static std::atomic<unsigned long long> fitted{0};
    if (cudaError_t e = fit_smem(jac_horner_kernel<T>, most, fitted))
        return (int)e;
    jac_horner_kernel<T><<<1, threads, bytes, s>>>(tot, ld, windows, out);
    return (int)cudaGetLastError();
}

// totals: (C, ld) words, columns 0..windows-1; out: (C, 1) words
extern "C" int zt_jac_horner(int curve, const void* totals, long ld,
                             int windows, void* out, void* stream) {
    if (windows <= 0 || windows > 64) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const u32* t = (const u32*)totals;
    u32* o = (u32*)out;
    return curve == 0 ? horner_launch<Fq>(t, ld, windows, o, s)
                      : horner_launch<Fq2>(t, ld, windows, o, s);
}
