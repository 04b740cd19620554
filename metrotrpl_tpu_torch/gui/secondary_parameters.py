"""Derived ("secondary") material quantities computed from posterior samples.

Same quantity set and formulas as the reference GUI's SecondaryParameters
(reference GUI/secondary_parameters.py:25-179). Parameters arrive in
[cm, V, s] units; thickness in nm; lifetimes returned in ns.
"""

import numpy as np

KB_EV = 0.0257  # thermal voltage at room temperature [eV]


def _diffusivity_nm2_ns(p):
    """Ambipolar diffusivity in nm^2/ns from mobilities in cm^2/(V s)."""
    return mu_ambi(p) * KB_EV * 1e14 / 1e9


def t_rad(p):
    """Radiative recombination lifetime [ns]."""
    return 1 / (p["ks"] * p["p0"]) * 1e9


def kp0(p):
    """Radiative rate constant ks*p0 [s^-1]."""
    return p["ks"] * p["p0"]


def t_auger(p):
    """Auger recombination lifetime [ns]."""
    return 1 / (p["Cp"] * p["p0"] ** 2) * 1e9


def mu_ambi(p):
    """Ambipolar mobility [cm^2 / (V s)]."""
    return 2 / (1 / p["mu_n"] + 1 / p["mu_p"])


def li_tau_surf(p):
    """Surface+diffusion lifetime, identical surfaces, low injection [ns]."""
    D = _diffusivity_nm2_ns(p)
    return (p["thickness"] / ((p["Sf"] + p["Sb"]) * 0.01)
            + p["thickness"] ** 2 / (np.pi ** 2 * D))


def hi_tau_surf(p):
    """Surface+diffusion lifetime, identical surfaces, high injection [ns]."""
    D = _diffusivity_nm2_ns(p)
    return (2 * p["thickness"] / ((p["Sf"] + p["Sb"]) * 0.01)
            + p["thickness"] ** 2 / (np.pi ** 2 * D))


def li_tau_surf_asy(p):
    """Surface+diffusion lifetime, asymmetric surfaces, low injection [ns]."""
    D = _diffusivity_nm2_ns(p)
    return (p["thickness"] / ((p["Sf"] + p["Sb"]) * 0.01)
            + 4 * p["thickness"] ** 2 / (np.pi ** 2 * D))


def hi_tau_surf_asy(p):
    """Surface+diffusion lifetime, asymmetric surfaces, high injection [ns]."""
    D = _diffusivity_nm2_ns(p)
    return (2 * p["thickness"] / ((p["Sf"] + p["Sb"]) * 0.01)
            + 4 * p["thickness"] ** 2 / (np.pi ** 2 * D))


def li_tau_srh(p):
    """Low-injection SRH(+surface) lifetime [ns]."""
    return 1 / (1 / li_tau_surf(p) + 1 / p["tauN"])


def hi_tau_srh(p):
    """High-injection SRH(+surface) lifetime [ns]."""
    return 1 / (1 / hi_tau_surf_asy(p) + 1 / (p["tauN"] + p["tauP"]))


def li_tau_eff(p):
    """Low-injection effective lifetime [ns]."""
    return 1 / (1 / t_rad(p) + 1 / t_auger(p) + 1 / li_tau_surf(p)
                + 1 / p["tauN"])


def hi_tau_eff(p):
    """High-injection effective lifetime [ns]."""
    return 1 / (1 / t_rad(p) + 1 / t_auger(p) + 1 / hi_tau_surf_asy(p)
                + 1 / (p["tauN"] + p["tauP"]))


def taun_taup(p):
    return p["tauN"] + p["tauP"]


def s_eff(p):
    return p["Sf"] + p["Sb"]


def c_eff(p):
    return p["Cn"] + p["Cp"]


def epsilon(p):
    """Relative permittivity from the inverse-eps 'lambda' parameter."""
    return 1 / p["lambda"]


def tau_c(p):
    """Maximum low-occupation trap capture time [ns]."""
    return 1 / (p["Nt"] * p["kC"]) * 1e9


def capture_rate(p):
    return 1 / tau_c(p)


def trap_rate(p):
    """Capture minus escape rate [s^-1]."""
    return p["kC"] * p["Nt"] - 1e9 / p["tauE"]


def n_removal_rate(p):
    """Total electron removal rate: SRH(+surface) + capture [s^-1]."""
    return 1e9 / hi_tau_srh(p) + p["kC"] * p["Nt"]


def inv_hi_tau_srh(p):
    return 1 / hi_tau_srh(p)


class SecondaryParameters:
    """Registry of derived quantities; mirrors the reference's interface
    (GUI/secondary_parameters.py:50-80): ``get(data, name, thickness)``
    computes the quantity from posterior sample arrays and caches it in
    ``data``."""

    def __init__(self):
        self.func = {
            "t_rad": (t_rad, ("ks", "p0")),
            "t_auger": (t_auger, ("Cp", "p0")),
            "LI_tau_eff": (li_tau_eff, ("ks", "p0", "tauN", "Sf", "Sb",
                                        "Cp", "thickness", "mu_n", "mu_p")),
            "HI_tau_eff": (hi_tau_eff, ("ks", "p0", "tauN", "tauP", "Sf",
                                        "Sb", "Cp", "thickness", "mu_n",
                                        "mu_p")),
            "LI_tau_srh": (li_tau_srh, ("tauN", "Sf", "Sb", "thickness",
                                        "mu_n", "mu_p")),
            "HI_tau_srh": (hi_tau_srh, ("tauN", "tauP", "Sf", "Sb",
                                        "thickness", "mu_n", "mu_p")),
            "tauN+tauP": (taun_taup, ("tauN", "tauP")),
            "LI_tau_surf": (li_tau_surf, ("Sf", "Sb", "thickness", "mu_n",
                                          "mu_p")),
            "LI_tau_surf_asy": (li_tau_surf_asy, ("Sf", "Sb", "thickness",
                                                  "mu_n", "mu_p")),
            "HI_tau_surf": (hi_tau_surf, ("Sf", "Sb", "thickness", "mu_n",
                                          "mu_p")),
            "HI_tau_surf_asy": (hi_tau_surf_asy, ("Sf", "Sb", "thickness",
                                                  "mu_n", "mu_p")),
            "Sf+Sb": (s_eff, ("Sf", "Sb")),
            "Cn+Cp": (c_eff, ("Cn", "Cp")),
            "mu_ambi": (mu_ambi, ("mu_n", "mu_p")),
            "epsilon": (epsilon, ("lambda",)),
            "tauC": (tau_c, ("kC", "Nt")),
            "Rc-Re": (trap_rate, ("kC", "Nt", "tauE")),
            "Rc+Rsrh": (n_removal_rate, ("tauN", "tauP", "Sf", "Sb",
                                         "thickness", "mu_n", "mu_p", "kC",
                                         "Nt", "tauE")),
            "kp0": (kp0, ("ks", "p0")),
            "1_tauSRH": (inv_hi_tau_srh, ("tauN", "tauP", "Sf", "Sb",
                                          "thickness", "mu_n", "mu_p")),
            "1_tauC": (capture_rate, ("kC", "Nt")),
        }

    def get(self, data, value, thickness):
        fn, needed = self.func[value]
        params = {}
        for name in needed:
            if name == "thickness":
                try:
                    params["thickness"] = float(thickness)
                except (TypeError, ValueError) as err:
                    raise ValueError("Thickness value needed") from err
            else:
                if name not in data:
                    raise KeyError(f"Missing parameter {name}")
                params[name] = data[name]
        data[value] = np.array(fn(params))
