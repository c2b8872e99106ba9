// The host sum tree's hot loops, for prioritized replay on the host
// (replay/prioritized.py through native.NativeSumTree).
//
// A copy of the st_* functions of distributed_ddpg_tpu/native/
// replay_core.cpp. replay/sum_tree.py does the same work as O(log C)
// vectorized numpy passes (with an np.unique a level); these walk each
// item's path cache-locally. The numpy tree stays the oracle and the
// fallback: the layout, the rounding and the draws are the same.
//
// Python owns every buffer (numpy arrays) and passes raw pointers;
// nothing here allocates or frees. The tree is 1-indexed: leaves at
// [capacity, 2 * capacity), node i the sum of nodes 2i and 2i + 1;
// capacity is a power of two.

#include <cstdint>

extern "C" {

// Set leaf priorities and repair their ancestors' sums. Each item walks
// its leaf's path to the root and recomputes each parent from both
// children, so duplicate indices and shared ancestors end at the sums of
// the final leaves.
void st_set(double* tree, int64_t capacity, const int64_t* indices,
            const double* priorities, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t node = capacity + indices[i];
        tree[node] = priorities[i];
        node >>= 1;
        while (node >= 1) {
            tree[node] = tree[2 * node] + tree[2 * node + 1];
            node >>= 1;
        }
    }
}

// Descend the tree for each value in [0, total); writes leaf indices.
void st_sample(const double* tree, int64_t capacity, const double* values,
               int64_t* out_indices, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        double v = values[i];
        int64_t node = 1;
        while (node < capacity) {
            int64_t left = 2 * node;
            double left_sum = tree[left];
            if (v < left_sum) {
                node = left;
            } else {
                v -= left_sum;
                node = left + 1;
            }
        }
        out_indices[i] = node - capacity;
    }
}

// Gather leaf priorities.
void st_get(const double* tree, int64_t capacity, const int64_t* indices,
            double* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = tree[capacity + indices[i]];
    }
}

}  // extern "C"
