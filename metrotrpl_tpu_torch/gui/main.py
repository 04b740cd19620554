"""GUI entry point:
``python -m metrotrpl_tpu_torch.gui.main [--device cuda|cpu] [pickles...]``
(reference GUI/main.py equivalent). Quicksim solves on ``--device``: the
card by default; without one it raises unless asked for the CPU."""

import argparse


def main(argv=None):
    from metrotrpl_tpu_torch.gui.window import Window

    ap = argparse.ArgumentParser(prog="metrotrpl_tpu_torch.gui.main")
    ap.add_argument("--device", default="cuda",
                    help="where quicksim solves: cuda (default) or cpu")
    ap.add_argument("pickles", nargs="*", help="Ensemble pickles to load")
    args = ap.parse_args(argv)
    win = Window(1100, 800, device=args.device)
    for fname in args.pickles:
        win.loadfile(fname)
    win.mainloop()


if __name__ == "__main__":
    main()
