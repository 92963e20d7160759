// Native I/O for Armon: fast writer/reader/comparator for the
// gnuplot-pm3d CSV state files (`src/io.jl:4-43` of the reference).
//
// This is the framework's native runtime tier for host-side I/O: at
// production scales (16384^2 = 2.7e8 cells x 6 saved vars) the Python
// formatter is minutes-slow; this C++ implementation streams the same
// byte-identical format (C printf %#w.pe, the same formatting the Julia
// reference uses via @printf) at disk speed.
//
// Exposed with a plain C ABI and loaded via ctypes (no pybind11 in the
// image). Built with the host `c++` on first use into build/armon_torch/
// (`armon_torch/ops/_build.py` `load_io`).

#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <locale.h>

// The format contract is byte-identical C-locale output ('.' decimal
// separator) and C-locale strtod parsing, regardless of what LC_NUMERIC
// the host Python process has set (any library calling
// locale.setlocale(LC_ALL, "") under e.g. de_DE would otherwise make
// fprintf emit ',' decimals — colliding with the field separator — and
// make strtod stop at '.'). RAII guard: pin the calling thread to the C
// locale for the duration of each entry point.
namespace {
struct CLocaleGuard {
    locale_t c_loc;
    locale_t old_loc;
    CLocaleGuard() {
        c_loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
        old_loc = c_loc ? uselocale(c_loc) : (locale_t)0;
    }
    ~CLocaleGuard() {
        if (c_loc) {
            uselocale(old_loc);
            freelocale(c_loc);
        }
    }
};
}  // namespace

extern "C" {

// Write `rows x cols` cells of `nvars` row-major (rows, cols) double arrays
// as lines of ", "-joined "%#(p+7).(p)e" fields, with a blank line between
// rows when for_3d != 0. Returns 0 on success, errno-style negative on error.
int armon_write_cells(const char* path, const double** vars, long nvars,
                      long rows, long cols, int precision, int for_3d,
                      const char* header) {
    CLocaleGuard loc;
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    // Large stdio buffer: the format is ~25 bytes per field.
    setvbuf(f, nullptr, _IOFBF, 1 << 22);

    if (header && header[0]) {
        fputs(header, f);
        fputc('\n', f);
    }

    char fmt[32];
    snprintf(fmt, sizeof(fmt), "%%#%d.%de", precision + 7, precision);

    for (long j = 0; j < rows; j++) {
        if (for_3d && j > 0) fputc('\n', f);
        for (long i = 0; i < cols; i++) {
            long idx = j * cols + i;
            for (long v = 0; v < nvars; v++) {
                if (v) fputs(", ", f);
                fprintf(f, fmt, vars[v][idx]);
            }
            fputc('\n', f);
        }
    }
    // Most bytes sit in the 4 MiB stdio buffer until fclose() flushes:
    // a disk-full/quota error often ONLY surfaces there, so its return
    // value must be part of the success check.
    int err = ferror(f);
    if (fclose(f) != 0) err = 1;
    return err ? -2 : 0;
}

// Parse all ','-separated doubles from `path` (blank lines skipped) into
// `out` (capacity `max_vals`). `skip_lines` initial lines are ignored
// (golden-file headers). Returns the number of values read, or negative on
// error / overflow.
long armon_read_cells(const char* path, double* out, long max_vals,
                      long skip_lines) {
    CLocaleGuard loc;
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    setvbuf(f, nullptr, _IOFBF, 1 << 22);

    char line[4096];
    long n = 0;
    long lineno = 0;
    while (fgets(line, sizeof(line), f)) {
        // A line longer than the buffer would be delivered in chunks and
        // a number straddling the boundary silently parsed as two values:
        // reject instead (state lines are ~25 bytes/field * nvars).
        size_t len = strlen(line);
        if (len == sizeof(line) - 1 && line[len - 1] != '\n') {
            fclose(f);
            return -3;
        }
        lineno++;
        if (lineno <= skip_lines) continue;
        const char* p = line;
        while (*p) {
            char* end = nullptr;
            double val = strtod(p, &end);
            if (end == p) break;  // no number here (blank line / junk)
            if (n >= max_vals) { fclose(f); return -2; }
            out[n++] = val;
            p = end;
            while (*p == ',' || *p == ' ' || *p == '\t') p++;
            if (*p == '\n' || *p == '\r') break;
        }
    }
    fclose(f);
    return n;
}

// Stream a GLOBAL-domain CSV and fill only the (hy x wx) window whose
// top-left cell sits at cell-row `row0` / cell-column `col0` of a
// `gnx`-cells-wide grid (the native tier of
// `io/subdomain.read_global_file_window` — host memory O(window), the
// per-shard golden comparator's inner loop). `out` receives hy*wx cells
// of `nvars` ','-separated fields each, cell-major (hy*wx, nvars).
// Lines with no leading number (pm3d blank separators) are skipped;
// `skip_lines` initial lines are ignored (headers). Returns the number
// of window CELLS filled (the caller checks for underfill — a truncated
// file or a grid/ghost-layout mismatch), or negative on error.
long armon_read_window(const char* path, double* out, long nvars,
                       long gnx, long row0, long col0, long hy, long wx,
                       long skip_lines) {
    CLocaleGuard loc;
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    setvbuf(f, nullptr, _IOFBF, 1 << 22);

    char line[4096];
    long lineno = 0;
    long row = 0;   // global cell-row index among data lines
    long cell = 0;  // cell index within the current row
    long filled = 0;
    while (fgets(line, sizeof(line), f)) {
        size_t len = strlen(line);
        if (len == sizeof(line) - 1 && line[len - 1] != '\n') {
            fclose(f);
            return -3;  // line straddles the buffer (see armon_read_cells)
        }
        lineno++;
        if (lineno <= skip_lines) continue;
        // Blank/non-numeric line: not a cell (pm3d row separator).
        const char* p = line;
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\n' || *p == '\r' || *p == '\0') continue;

        if (row >= row0 && row < row0 + hy &&
            cell >= col0 && cell < col0 + wx) {
            double* dst = out + filled * nvars;
            for (long v = 0; v < nvars; v++) {
                char* end = nullptr;
                double val = strtod(p, &end);
                if (end == p) { fclose(f); return -4; }  // short line
                dst[v] = val;
                p = end;
                while (*p == ',' || *p == ' ' || *p == '\t') p++;
            }
            filled++;
        }
        cell++;
        if (cell == gnx) {
            cell = 0;
            row++;
            if (row >= row0 + hy) break;  // window complete
        }
    }
    fclose(f);
    return filled;
}

// Count cells where |ref - ours| > max(atol, rtol*max(|ref|,|ours|))
// (Julia isapprox semantics, `reference_functions.jl:69-121`). Writes the
// max relative difference over differing cells to *max_rel.
long armon_count_differences(const double* ref, const double* ours, long n,
                             double atol, double rtol, double* max_rel) {
    long count = 0;
    double mr = 0.0;
    for (long i = 0; i < n; i++) {
        double a = ref[i], b = ours[i];
        double err = a > b ? a - b : b - a;
        double aa = a < 0 ? -a : a;
        double ab = b < 0 ? -b : b;
        double scale = aa > ab ? aa : ab;
        double tol = rtol * scale;
        if (tol < atol) tol = atol;
        // Negated comparison so NaN counts as a difference (Julia
        // !isapprox(NaN, x) semantics): err > tol is false for NaN.
        if (!(err <= tol)) {
            count++;
            double denom = aa > 0 ? aa : 5e-324;
            double rel = err / denom;
            if (rel > mr) mr = rel;
        }
    }
    *max_rel = mr;
    return count;
}

}  // extern "C"
