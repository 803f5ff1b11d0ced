// CRAFT heatmap box extraction — native C++ implementation of the detection
// postprocessing hot loop (the reference leans on OpenCV for this:
// surya/detection/heatmap.py:27-107 — connectedComponentsWithStats, dilate,
// minAreaRect). One call does the whole per-page pipeline: threshold →
// 4-connected components (union-find) → per-component rectangular dilation →
// min-area rectangle via convex hull + rotating calipers → near-square snap
// → clockwise corner order.
//
// Build: g++ -O3 -march=native -shared -fPIC craft_ops.cpp -o libcraft_ops.so
// ABI (ctypes):
//   int craft_extract_boxes(const float* linemap, int h, int w,
//                           float text_threshold, float low_text,
//                           float* out_quads /*[max_boxes*8]*/,
//                           float* out_confs /*[max_boxes]*/, int max_boxes);
//   int craft_extract_boxes_u8(const uint8_t* linemap, ...same...);
// Returns the number of boxes written. The u8 variant takes the quantized
// heatmap (value = round(p * 255)) with thresholds still in [0, 1] and
// reports confidences back in [0, 1] — the detection D2H path ships uint8
// maps, and on a single-core host the float32 expansion of a full page map
// costs more than this whole routine.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Point {
    float x, y;
};

// Andrew monotone chain; returns hull in counter-clockwise order.
static std::vector<Point> convex_hull(std::vector<Point> pts) {
    std::sort(pts.begin(), pts.end(), [](const Point& a, const Point& b) {
        return a.x < b.x || (a.x == b.x && a.y < b.y);
    });
    pts.erase(std::unique(pts.begin(), pts.end(), [](const Point& a, const Point& b) {
        return a.x == b.x && a.y == b.y;
    }), pts.end());
    const size_t n = pts.size();
    if (n <= 2) return pts;

    auto cross = [](const Point& o, const Point& a, const Point& b) {
        return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
    };
    std::vector<Point> hull(2 * n);
    size_t k = 0;
    for (size_t i = 0; i < n; i++) {
        while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) k--;
        hull[k++] = pts[i];
    }
    const size_t lower = k + 1;
    for (size_t i = n - 1; i-- > 0;) {
        while (k >= lower && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) k--;
        hull[k++] = pts[i];
    }
    hull.resize(k - 1);
    return hull;
}

// Rotating calipers minimal-area enclosing rectangle; writes 4 corners.
static void min_area_rect(const std::vector<Point>& points, Point out[4]) {
    std::vector<Point> hull = convex_hull(points);
    const size_t n = hull.size();
    if (n == 0) return;
    if (n == 1) {
        for (int i = 0; i < 4; i++) out[i] = hull[0];
        return;
    }
    if (n == 2) {
        out[0] = hull[0]; out[1] = hull[1]; out[2] = hull[1]; out[3] = hull[0];
        return;
    }

    float best_area = -1.0f;
    for (size_t i = 0; i < n; i++) {
        const Point& a = hull[i];
        const Point& b = hull[(i + 1) % n];
        float ex = b.x - a.x, ey = b.y - a.y;
        float len = std::sqrt(ex * ex + ey * ey);
        if (len < 1e-9f) continue;
        ex /= len; ey /= len;
        // perpendicular
        float px = -ey, py = ex;

        float min_e = 1e30f, max_e = -1e30f, min_p = 1e30f, max_p = -1e30f;
        for (const Point& q : hull) {
            float de = q.x * ex + q.y * ey;
            float dp = q.x * px + q.y * py;
            min_e = std::min(min_e, de); max_e = std::max(max_e, de);
            min_p = std::min(min_p, dp); max_p = std::max(max_p, dp);
        }
        float area = (max_e - min_e) * (max_p - min_p);
        if (best_area < 0 || area < best_area) {
            best_area = area;
            out[0] = {ex * min_e + px * min_p, ey * min_e + py * min_p};
            out[1] = {ex * max_e + px * min_p, ey * max_e + py * min_p};
            out[2] = {ex * max_e + px * max_p, ey * max_e + py * max_p};
            out[3] = {ex * min_e + px * max_p, ey * min_e + py * max_p};
        }
    }
}

// One pipeline for float ([0,1]) and uint8 (value*255) maps: thresholds come
// in [0,1] and are scaled to the pixel domain; confidences scale back.
template <typename T>
static int extract_boxes_impl(
    const T* linemap, int h, int w,
    float text_threshold, float low_text, float pixel_scale,
    float* out_quads, float* out_confs, int max_boxes) {
    const int64_t total = static_cast<int64_t>(h) * w;
    text_threshold *= pixel_scale;
    low_text *= pixel_scale;

    // 1) threshold + two-pass 4-connected components with union-find
    std::vector<int32_t> labels(total, 0);
    std::vector<int32_t> parent(1, 0);  // parent[0] = background
    auto find = [&](int32_t x) {
        while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
        return x;
    };
    auto unite = [&](int32_t a, int32_t b) {
        a = find(a); b = find(b);
        if (a != b) parent[std::max(a, b)] = std::min(a, b);
    };

    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            const int64_t idx = static_cast<int64_t>(y) * w + x;
            if (!(linemap[idx] > low_text)) continue;
            int32_t left = (x > 0) ? labels[idx - 1] : 0;
            int32_t up = (y > 0) ? labels[idx - w] : 0;
            if (left && up) {
                labels[idx] = std::min(find(left), find(up));
                unite(left, up);
            } else if (left || up) {
                labels[idx] = left ? left : up;
            } else {
                parent.push_back(static_cast<int32_t>(parent.size()));
                labels[idx] = static_cast<int32_t>(parent.size()) - 1;
            }
        }
    }

    // relabel to contiguous ids in row-major first-encounter order
    std::vector<int32_t> remap(parent.size(), -1);
    int32_t n_comp = 0;
    for (int64_t idx = 0; idx < total; idx++) {
        if (!labels[idx]) continue;
        int32_t root = find(labels[idx]);
        if (remap[root] < 0) remap[root] = ++n_comp;
        labels[idx] = remap[root];
    }

    // stats: area + bbox per component
    std::vector<int64_t> area(n_comp + 1, 0);
    std::vector<int> min_x(n_comp + 1, w), min_y(n_comp + 1, h);
    std::vector<int> max_x(n_comp + 1, -1), max_y(n_comp + 1, -1);
    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            int32_t l = labels[static_cast<int64_t>(y) * w + x];
            if (!l) continue;
            area[l]++;
            min_x[l] = std::min(min_x[l], x); max_x[l] = std::max(max_x[l], x);
            min_y[l] = std::min(min_y[l], y); max_y[l] = std::max(max_y[l], y);
        }
    }

    // 2) per-component: max-intensity gate, dilation, min-area rect
    int n_out = 0;
    std::vector<uint8_t> dilated;
    for (int32_t comp = 1; comp <= n_comp && n_out < max_boxes; comp++) {
        if (area[comp] < 10) continue;
        const int bw = max_x[comp] - min_x[comp] + 1;
        const int bh = max_y[comp] - min_y[comp] + 1;
        const int niter = static_cast<int>(std::sqrt(static_cast<float>(std::min(bw, bh))));
        const int buffer = 1;
        const int sx = std::max(0, min_x[comp] - niter - buffer);
        const int sy = std::max(0, min_y[comp] - niter - buffer);
        // reference window: [y - pad, y + h_comp + pad) x [x - pad, x + w_comp + pad)
        const int ey = std::min(h, max_y[comp] + 1 + niter + buffer);
        const int ex2 = std::min(w, max_x[comp] + 1 + niter + buffer);

        const int wh = ey - sy, ww = ex2 - sx;
        if (wh <= 0 || ww <= 0) continue;

        float line_max = -1e30f;
        for (int y = sy; y < ey; y++) {
            const int64_t row = static_cast<int64_t>(y) * w;
            for (int x = sx; x < ex2; x++) {
                if (labels[row + x] == comp)
                    line_max = std::max(line_max, static_cast<float>(linemap[row + x]));
            }
        }
        if (line_max < text_threshold) continue;

        // rectangular dilation of the component mask inside the window;
        // kernel ksize x ksize with OpenCV's anchor (ksize/2, ksize/2):
        // neighborhood offsets [-(ksize/2), ksize-1-ksize/2]
        const int ksize = buffer + niter;
        const int lo = ksize / 2;
        const int hi = ksize - 1 - lo;
        dilated.assign(static_cast<size_t>(wh) * ww, 0);
        for (int y = sy; y < ey; y++) {
            const int64_t row = static_cast<int64_t>(y) * w;
            for (int x = sx; x < ex2; x++) {
                if (labels[row + x] != comp) continue;
                const int y0 = std::max(sy, y - lo), y1 = std::min(ey - 1, y + hi);
                const int x0 = std::max(sx, x - lo), x1 = std::min(ex2 - 1, x + hi);
                for (int yy = y0; yy <= y1; yy++) {
                    uint8_t* drow = &dilated[static_cast<size_t>(yy - sy) * ww];
                    for (int xx = x0; xx <= x1; xx++) drow[xx - sx] = 1;
                }
            }
        }

        std::vector<Point> points;
        points.reserve(256);
        float pmin_x = 1e30f, pmin_y = 1e30f, pmax_x = -1e30f, pmax_y = -1e30f;
        for (int y = 0; y < wh; y++) {
            const uint8_t* drow = &dilated[static_cast<size_t>(y) * ww];
            for (int x = 0; x < ww; x++) {
                if (!drow[x]) continue;
                Point pt{static_cast<float>(x + sx), static_cast<float>(y + sy)};
                points.push_back(pt);
                pmin_x = std::min(pmin_x, pt.x); pmax_x = std::max(pmax_x, pt.x);
                pmin_y = std::min(pmin_y, pt.y); pmax_y = std::max(pmax_y, pt.y);
            }
        }
        if (points.empty()) continue;

        Point box[4];
        min_area_rect(points, box);

        // near-square quads snap to the axis-aligned bbox (reference :87-96)
        const float side_a = std::hypot(box[0].x - box[1].x, box[0].y - box[1].y);
        const float side_b = std::hypot(box[1].x - box[2].x, box[1].y - box[2].y);
        const float ratio = std::max(side_a, side_b) / (std::min(side_a, side_b) + 1e-5f);
        if (std::fabs(1.0f - ratio) <= 0.1f) {
            box[0] = {pmin_x, pmin_y};
            box[1] = {pmax_x, pmin_y};
            box[2] = {pmax_x, pmax_y};
            box[3] = {pmin_x, pmax_y};
        }

        // enforce clockwise winding in image coords (x right, y down)
        {
            const float ux = box[1].x - box[0].x, uy = box[1].y - box[0].y;
            const float vx = box[3].x - box[0].x, vy = box[3].y - box[0].y;
            if (ux * vy - uy * vx < 0) std::swap(box[1], box[3]);
        }

        // clockwise order starting at the top-left-most corner
        int start = 0;
        float best = box[0].x + box[0].y;
        for (int i = 1; i < 4; i++) {
            const float s = box[i].x + box[i].y;
            if (s < best) { best = s; start = i; }
        }
        for (int i = 0; i < 4; i++) {
            const Point& p = box[(start + i) % 4];
            out_quads[n_out * 8 + 2 * i] = p.x;
            out_quads[n_out * 8 + 2 * i + 1] = p.y;
        }
        out_confs[n_out] = line_max / pixel_scale;
        n_out++;
    }
    return n_out;
}

}  // namespace

extern "C" int craft_extract_boxes(
    const float* linemap, int h, int w,
    float text_threshold, float low_text,
    float* out_quads, float* out_confs, int max_boxes) {
    return extract_boxes_impl<float>(
        linemap, h, w, text_threshold, low_text, 1.0f, out_quads, out_confs, max_boxes);
}

extern "C" int craft_extract_boxes_u8(
    const uint8_t* linemap, int h, int w,
    float text_threshold, float low_text,
    float* out_quads, float* out_confs, int max_boxes) {
    return extract_boxes_impl<uint8_t>(
        linemap, h, w, text_threshold, low_text, 255.0f, out_quads, out_confs, max_boxes);
}
