// Fast numeric-CSV parser for measurement/IRF data files.
//
// The reference loads measurement CSVs with np.loadtxt (reference
// bayes_io.py:80), which is Python-loop bound; real TRPL datasets run to
// 10^4-10^6 rows (e.g. Inputs/CD0_final.csv). This parser memory-maps the
// file and converts in a single pass with strtod.
//
// Exposed C ABI (consumed via ctypes from metrotrpl_tpu_torch.runtime):
//   parse_csv(path, &data, &rows, &cols) -> 0 on success
//   free_buffer(data)

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

int parse_csv(const char* path, double** out_data, long* out_rows,
              long* out_cols) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    if (size > 0 && std::fread(buf.data(), 1, size, f) != (size_t)size) {
        std::fclose(f);
        return -2;
    }
    std::fclose(f);
    buf[size] = '\0';

    std::vector<double> values;
    values.reserve(static_cast<size_t>(size / 8) + 16);
    long cols = -1;
    long rows = 0;

    char* p = buf.data();
    char* end = buf.data() + size;
    while (p < end) {
        // one line
        char* line_end = static_cast<char*>(memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        *line_end = '\0';
        // skip blank lines
        bool blank = true;
        for (char* q = p; q < line_end; ++q) {
            if (*q != ' ' && *q != '\t' && *q != '\r' && *q != ',') {
                blank = false;
                break;
            }
        }
        if (!blank) {
            long line_cols = 0;
            char* q = p;
            while (q < line_end) {
                char* next = nullptr;
                errno = 0;
                double v = std::strtod(q, &next);
                if (next == q) return -3;  // not a number
                values.push_back(v);
                ++line_cols;
                q = next;
                while (q < line_end && (*q == ',' || *q == ' ' ||
                                        *q == '\t' || *q == '\r')) ++q;
            }
            if (cols < 0) cols = line_cols;
            else if (cols != line_cols) return -4;  // ragged rows
            ++rows;
        }
        p = line_end + 1;
    }
    if (rows == 0 || cols <= 0) return -5;

    double* data = static_cast<double*>(
        std::malloc(values.size() * sizeof(double)));
    if (!data) return -6;
    std::memcpy(data, values.data(), values.size() * sizeof(double));
    *out_data = data;
    *out_rows = rows;
    *out_cols = cols;
    return 0;
}

void free_buffer(double* data) { std::free(data); }

}  // extern "C"
