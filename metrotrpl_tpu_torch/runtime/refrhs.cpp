// Compiled (numba-equivalent) implementation of the reference's std-model
// drift-diffusion RHS, for the LSODA oracle's rhs="native" path: the
// reference runs this RHS numba-JIT-compiled under scipy LSODA
// (reference forward_solver.py:332-372); numba is not a
// dependency, so a g++ -O3 scalar-loop build stands in for the machine
// code numba would emit. Same math, same allocation pattern (numba's
// version np.zeros-allocates Jn/Jp/dy each call).
//
// State layout (reference): y = [N(0..L-1), P(0..L-1), E(0..L)].

#include <cstdlib>
#include <cstring>

static const double KB = 8.61773e-5;  // [eV / K]

extern "C" {

void dydt_std(int L, double dx, double n0, double p0, double mu_n,
              double mu_p, double ks, double cn, double cp, double sf,
              double sb, double tauN, double tauP, double lam, double Tm,
              const double* y, double* dy) {
    const double* N = y;
    const double* P = y + L;
    const double* E = y + 2 * L;
    double* Jn = (double*)std::malloc(sizeof(double) * (L + 1));
    double* Jp = (double*)std::malloc(sizeof(double) * (L + 1));

    const double Dn = mu_n * KB * Tm;
    const double Dp = mu_p * KB * Tm;

    const double np0 = N[0] * P[0] - n0 * p0;
    const double npL = N[L - 1] * P[L - 1] - n0 * p0;
    const double sft = sf * np0 / (N[0] + P[0]);
    const double sbt = sb * npL / (N[L - 1] + P[L - 1]);

    Jn[0] = sft;
    Jn[L] = -sbt;
    Jp[0] = -sft;
    Jp[L] = sbt;

    for (int i = 1; i < L; ++i) {
        const double ne = 0.5 * (N[i - 1] + N[i]);
        const double pe = 0.5 * (P[i - 1] + P[i]);
        Jn[i] = mu_n * ne * E[i] + Dn * (N[i] - N[i - 1]) / dx;
        Jp[i] = mu_p * pe * E[i] - Dp * (P[i] - P[i - 1]) / dx;
    }

    // dE/dt over all L+1 edges
    for (int i = 0; i <= L; ++i) {
        dy[2 * L + i] = -(Jn[i] + Jp[i]) * lam;
    }

    for (int i = 0; i < L; ++i) {
        const double np_i = N[i] * P[i] - n0 * p0;
        const double recomb =
            ((cn * N[i] + cp * P[i]) + ks +
             1.0 / (tauN * P[i] + tauP * N[i])) * np_i;
        dy[i] = (Jn[i + 1] - Jn[i]) / dx - recomb;
        dy[L + i] = -(Jp[i + 1] - Jp[i]) / dx - recomb;
    }

    std::free(Jn);
    std::free(Jp);
}

}  // extern "C"
