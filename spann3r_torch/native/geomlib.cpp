// geomlib: native CPU geometry runtime for spann3r_tpu.
//
// TPU-native equivalent of the reference's CPU-side eval machinery
// (scipy cKDTree chamfer metrics, open3d ICP + normal estimation):
// a 3-D KD-tree with nearest-neighbour / k-NN queries, point-to-point ICP
// with a closed-form Kabsch step, and PCA normal estimation — exposed via a
// plain C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC geomlib.cpp -o libgeomlib.so
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

struct KDTree {
    // implicit balanced tree over point indices; nodes split on the widest
    // axis at the median
    std::vector<float> pts;   // (n, 3) row-major copy
    std::vector<int> idx;     // permutation defining the tree layout
    int n = 0;

    const float* p(int i) const { return &pts[3 * (size_t)idx[i]]; }

    void build(const float* data, int count) {
        n = count;
        pts.assign(data, data + 3 * (size_t)count);
        idx.resize(n);
        std::iota(idx.begin(), idx.end(), 0);
        build_range(0, n, 0);
    }

    void build_range(int lo, int hi, int depth) {
        if (hi - lo <= 1) return;
        int axis = widest_axis(lo, hi);
        int mid = (lo + hi) / 2;
        std::nth_element(idx.begin() + lo, idx.begin() + mid,
                         idx.begin() + hi, [&](int a, int b) {
                             return pts[3 * (size_t)a + axis] <
                                    pts[3 * (size_t)b + axis];
                         });
        // stash the split axis in the high bits? keep it simple: recompute
        axes.resize(std::max<size_t>(axes.size(), (size_t)n));
        axes[mid] = (int8_t)axis;
        build_range(lo, mid, depth + 1);
        build_range(mid + 1, hi, depth + 1);
    }

    int widest_axis(int lo, int hi) const {
        float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
        for (int i = lo; i < hi; i++) {
            const float* q = p(i);
            for (int a = 0; a < 3; a++) {
                mn[a] = std::min(mn[a], q[a]);
                mx[a] = std::max(mx[a], q[a]);
            }
        }
        int best = 0;
        for (int a = 1; a < 3; a++)
            if (mx[a] - mn[a] > mx[best] - mn[best]) best = a;
        return best;
    }

    std::vector<int8_t> axes;

    void nn_range(const float* q, int lo, int hi, int& best_i,
                  float& best_d2) const {
        if (hi <= lo) return;
        int mid = (lo + hi) / 2;
        const float* m = p(mid);
        float dx = q[0] - m[0], dy = q[1] - m[1], dz = q[2] - m[2];
        float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best_d2) { best_d2 = d2; best_i = idx[mid]; }
        if (hi - lo == 1) return;
        int axis = axes[mid];
        float delta = q[axis] - m[axis];
        if (delta < 0) {
            nn_range(q, lo, mid, best_i, best_d2);
            if (delta * delta < best_d2) nn_range(q, mid + 1, hi, best_i, best_d2);
        } else {
            nn_range(q, mid + 1, hi, best_i, best_d2);
            if (delta * delta < best_d2) nn_range(q, lo, mid, best_i, best_d2);
        }
    }

    void knn_range(const float* q, int lo, int hi, int k,
                   std::vector<std::pair<float, int>>& heap) const {
        if (hi <= lo) return;
        int mid = (lo + hi) / 2;
        const float* m = p(mid);
        float dx = q[0] - m[0], dy = q[1] - m[1], dz = q[2] - m[2];
        float d2 = dx * dx + dy * dy + dz * dz;
        if ((int)heap.size() < k) {
            heap.emplace_back(d2, idx[mid]);
            std::push_heap(heap.begin(), heap.end());
        } else if (d2 < heap.front().first) {
            std::pop_heap(heap.begin(), heap.end());
            heap.back() = {d2, idx[mid]};
            std::push_heap(heap.begin(), heap.end());
        }
        if (hi - lo == 1) return;
        int axis = axes[mid];
        float delta = q[axis] - m[axis];
        float bound = ((int)heap.size() < k)
                          ? std::numeric_limits<float>::max()
                          : heap.front().first;
        if (delta < 0) {
            knn_range(q, lo, mid, k, heap);
            bound = ((int)heap.size() < k)
                        ? std::numeric_limits<float>::max()
                        : heap.front().first;
            if (delta * delta < bound) knn_range(q, mid + 1, hi, k, heap);
        } else {
            knn_range(q, mid + 1, hi, k, heap);
            bound = ((int)heap.size() < k)
                        ? std::numeric_limits<float>::max()
                        : heap.front().first;
            if (delta * delta < bound) knn_range(q, lo, mid, k, heap);
        }
    }
};

// ---- 3x3 symmetric eigen (Jacobi) + Kabsch SVD via eigen of A^T A --------

void jacobi3(const double a_in[9], double eigvec[9], double eigval[3]) {
    double a[9];
    std::memcpy(a, a_in, sizeof a);
    double v[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
    for (int sweep = 0; sweep < 32; sweep++) {
        double off = std::abs(a[1]) + std::abs(a[2]) + std::abs(a[5]);
        if (off < 1e-15) break;
        for (int p = 0; p < 2; p++)
            for (int q = p + 1; q < 3; q++) {
                double apq = a[3 * p + q];
                if (std::abs(apq) < 1e-18) continue;
                double app = a[3 * p + p], aqq = a[3 * q + q];
                double phi = 0.5 * std::atan2(2 * apq, aqq - app);
                double c = std::cos(phi), s = std::sin(phi);
                for (int k = 0; k < 3; k++) {
                    double akp = a[3 * k + p], akq = a[3 * k + q];
                    a[3 * k + p] = c * akp - s * akq;
                    a[3 * k + q] = s * akp + c * akq;
                }
                for (int k = 0; k < 3; k++) {
                    double apk = a[3 * p + k], aqk = a[3 * q + k];
                    a[3 * p + k] = c * apk - s * aqk;
                    a[3 * q + k] = s * apk + c * aqk;
                }
                for (int k = 0; k < 3; k++) {
                    double vkp = v[3 * k + p], vkq = v[3 * k + q];
                    v[3 * k + p] = c * vkp - s * vkq;
                    v[3 * k + q] = s * vkp + c * vkq;
                }
            }
    }
    for (int i = 0; i < 3; i++) eigval[i] = a[3 * i + i];
    std::memcpy(eigvec, v, sizeof v);
}

// Best-fit rotation R, translation t minimizing |R*src + t - dst|^2
// (Kabsch via eigendecomposition of H^T H with sign fix).
void kabsch(const std::vector<double>& src, const std::vector<double>& dst,
            int n, double r_out[9], double t_out[3]) {
    double cs[3] = {0, 0, 0}, cd[3] = {0, 0, 0};
    for (int i = 0; i < n; i++)
        for (int a = 0; a < 3; a++) {
            cs[a] += src[3 * i + a];
            cd[a] += dst[3 * i + a];
        }
    for (int a = 0; a < 3; a++) { cs[a] /= n; cd[a] /= n; }
    double h[9] = {0};
    for (int i = 0; i < n; i++)
        for (int a = 0; a < 3; a++)
            for (int b = 0; b < 3; b++)
                h[3 * a + b] += (src[3 * i + a] - cs[a]) *
                                (dst[3 * i + b] - cd[b]);
    // SVD of H: H = U S V^T; columns of V from eig(H^T H), U = H V S^-1
    double hth[9] = {0};
    for (int a = 0; a < 3; a++)
        for (int b = 0; b < 3; b++)
            for (int k = 0; k < 3; k++)
                hth[3 * a + b] += h[3 * k + a] * h[3 * k + b];
    double vmat[9], eval[3];
    jacobi3(hth, vmat, eval);
    double u[9];
    for (int a = 0; a < 3; a++)
        for (int b = 0; b < 3; b++) {
            double s = std::sqrt(std::max(eval[b], 1e-30));
            double acc = 0;
            for (int k = 0; k < 3; k++) acc += h[3 * a + k] * vmat[3 * k + b];
            u[3 * a + b] = acc / s;
        }
    // R = V U^T (rotates src onto dst) with det fix
    double r[9];
    auto fill_r = [&]() {
        for (int a = 0; a < 3; a++)
            for (int b = 0; b < 3; b++) {
                double acc = 0;
                for (int k = 0; k < 3; k++)
                    acc += vmat[3 * a + k] * u[3 * b + k];
                r[3 * a + b] = acc;
            }
    };
    fill_r();
    double det = r[0] * (r[4] * r[8] - r[5] * r[7]) -
                 r[1] * (r[3] * r[8] - r[5] * r[6]) +
                 r[2] * (r[3] * r[7] - r[4] * r[6]);
    if (det < 0) {  // flip the smallest-singular-value column of U
        int mi = 0;
        for (int i = 1; i < 3; i++) if (eval[i] < eval[mi]) mi = i;
        for (int k = 0; k < 3; k++) u[3 * k + mi] = -u[3 * k + mi];
        fill_r();
    }
    std::memcpy(r_out, r, sizeof r);
    for (int a = 0; a < 3; a++) {
        double acc = 0;
        for (int k = 0; k < 3; k++) acc += r[3 * a + k] * cs[k];
        t_out[a] = cd[a] - acc;
    }
}

}  // namespace

extern "C" {

// ---- KD-tree handle API --------------------------------------------------

void* kdtree_build(const float* pts, int n) {
    auto* t = new KDTree();
    t->build(pts, n);
    return t;
}

void kdtree_free(void* handle) { delete static_cast<KDTree*>(handle); }

void kdtree_query(void* handle, const float* queries, int nq, float* out_dist,
                  int* out_idx) {
    auto* t = static_cast<KDTree*>(handle);
    for (int i = 0; i < nq; i++) {
        int bi = -1;
        float bd = std::numeric_limits<float>::max();
        t->nn_range(&queries[3 * (size_t)i], 0, t->n, bi, bd);
        out_dist[i] = std::sqrt(bd);
        out_idx[i] = bi;
    }
}

void kdtree_knn(void* handle, const float* queries, int nq, int k,
                int* out_idx) {
    auto* t = static_cast<KDTree*>(handle);
    std::vector<std::pair<float, int>> heap;
    for (int i = 0; i < nq; i++) {
        heap.clear();
        t->knn_range(&queries[3 * (size_t)i], 0, t->n, k, heap);
        std::sort_heap(heap.begin(), heap.end());
        for (int j = 0; j < k; j++)
            out_idx[(size_t)i * k + j] =
                j < (int)heap.size() ? heap[j].second : heap.back().second;
    }
}

// ---- ICP ----------------------------------------------------------------

// Point-to-point ICP aligning src -> dst. transform: 4x4 row-major in/out.
void icp_p2p(const float* src, int ns, const float* dst, int nd,
             float threshold, int max_iters, double* transform) {
    KDTree tree;
    tree.build(dst, nd);
    double tr[16];
    std::memcpy(tr, transform, sizeof tr);
    std::vector<double> cur(3 * (size_t)ns);
    std::vector<double> csrc, cdst;
    double prev_rmse = std::numeric_limits<double>::max();
    for (int it = 0; it < max_iters; it++) {
        for (int i = 0; i < ns; i++) {
            const float* q = &src[3 * (size_t)i];
            for (int a = 0; a < 3; a++)
                cur[3 * (size_t)i + a] = tr[4 * a + 0] * q[0] +
                                         tr[4 * a + 1] * q[1] +
                                         tr[4 * a + 2] * q[2] + tr[4 * a + 3];
        }
        csrc.clear();
        cdst.clear();
        double sum2 = 0;
        int kept = 0;
        for (int i = 0; i < ns; i++) {
            float q[3] = {(float)cur[3 * (size_t)i], (float)cur[3 * (size_t)i + 1],
                          (float)cur[3 * (size_t)i + 2]};
            int bi = -1;
            float bd = std::numeric_limits<float>::max();
            tree.nn_range(q, 0, tree.n, bi, bd);
            float d = std::sqrt(bd);
            if (d < threshold) {
                for (int a = 0; a < 3; a++) csrc.push_back(cur[3 * (size_t)i + a]);
                const float* dpt = &dst[3 * (size_t)bi];
                for (int a = 0; a < 3; a++) cdst.push_back(dpt[a]);
                sum2 += (double)bd;
                kept++;
            }
        }
        if (kept < 3) break;
        double r[9], t[3];
        kabsch(csrc, cdst, kept, r, t);
        // tr = [R|t] * tr
        double ntr[16];
        for (int a = 0; a < 3; a++) {
            for (int b = 0; b < 4; b++) {
                double acc = 0;
                for (int k = 0; k < 3; k++) acc += r[3 * a + k] * tr[4 * k + b];
                if (b == 3) acc += t[a];
                ntr[4 * a + b] = acc;
            }
        }
        ntr[12] = 0; ntr[13] = 0; ntr[14] = 0; ntr[15] = 1;
        std::memcpy(tr, ntr, sizeof tr);
        double rmse = std::sqrt(sum2 / kept);
        if (std::abs(prev_rmse - rmse) < 1e-7) break;
        prev_rmse = rmse;
    }
    std::memcpy(transform, tr, sizeof tr);
}

// ---- PCA normals --------------------------------------------------------

void estimate_normals(const float* pts, int n, int k, float* out_normals) {
    KDTree tree;
    tree.build(pts, n);
    if (k > n) k = n;
    std::vector<std::pair<float, int>> heap;
    std::vector<int> nbr(k);
    for (int i = 0; i < n; i++) {
        heap.clear();
        tree.knn_range(&pts[3 * (size_t)i], 0, tree.n, k, heap);
        double mean[3] = {0, 0, 0};
        int kk = (int)heap.size();
        for (auto& h : heap)
            for (int a = 0; a < 3; a++) mean[a] += pts[3 * (size_t)h.second + a];
        for (int a = 0; a < 3; a++) mean[a] /= kk;
        double cov[9] = {0};
        for (auto& h : heap) {
            const float* q = &pts[3 * (size_t)h.second];
            double d[3] = {q[0] - mean[0], q[1] - mean[1], q[2] - mean[2]};
            for (int a = 0; a < 3; a++)
                for (int b = 0; b < 3; b++) cov[3 * a + b] += d[a] * d[b];
        }
        double v[9], e[3];
        jacobi3(cov, v, e);
        int mi = 0;
        for (int a = 1; a < 3; a++) if (e[a] < e[mi]) mi = a;
        for (int a = 0; a < 3; a++)
            out_normals[3 * (size_t)i + a] = (float)v[3 * a + mi];
    }
}

// ---- chamfer helpers ----------------------------------------------------

// mean + median NN distance from queries to the tree over `ref`.
void chamfer_stats(const float* ref, int nr, const float* queries, int nq,
                   double* mean_out, double* median_out) {
    KDTree tree;
    tree.build(ref, nr);
    std::vector<float> dists((size_t)nq);
    double sum = 0;
    for (int i = 0; i < nq; i++) {
        int bi = -1;
        float bd = std::numeric_limits<float>::max();
        tree.nn_range(&queries[3 * (size_t)i], 0, tree.n, bi, bd);
        dists[i] = std::sqrt(bd);
        sum += dists[i];
    }
    *mean_out = sum / nq;
    std::nth_element(dists.begin(), dists.begin() + nq / 2, dists.end());
    double med = dists[nq / 2];
    if (nq % 2 == 0) {
        std::nth_element(dists.begin(), dists.begin() + nq / 2 - 1,
                         dists.end());
        med = 0.5 * (med + dists[nq / 2 - 1]);
    }
    *median_out = med;
}

}  // extern "C"
