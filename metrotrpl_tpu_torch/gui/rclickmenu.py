"""Right-click context menu for chart figures (reference GUI/rclickmenu.py).

``FigureClickmenu`` adds figure clipboard copy and save-as-PNG/SVG to any
matplotlib canvas. The reference's clipboard path is Windows-only
(win32clipboard); this port goes through ``xclip``/``wl-copy`` on Linux and
``pbcopy`` is not image-capable, so macOS raises like the reference does on
non-Windows platforms.
"""

import shutil
import subprocess
from functools import partial
from io import BytesIO

CLICK_EVENTS = {"click": {"left": "<Button-1>", "right": "<Button-3>"}}


def _clipboard_backend():
    """Return (cmd, label) of an available image-clipboard tool, else None."""
    if shutil.which("wl-copy"):
        return (["wl-copy", "--type", "image/png"], "wl-copy")
    if shutil.which("xclip"):
        return (["xclip", "-selection", "clipboard",
                 "-t", "image/png", "-i"], "xclip")
    return None


class Clickmenu:
    """Menu of options shown on right-click (reference rclickmenu.py:21-39)."""

    def __init__(self, window, master, target_widget):
        import tkinter as tk

        self.window = window
        self.master = master
        self.target_widget = target_widget
        self.menu = tk.Menu(self.master, tearoff=0)
        self.latest_event = (-1, -1)

    def show(self, event):
        """Display menu at the click-event location."""
        if event.widget != self.target_widget:
            return
        try:
            self.menu.tk_popup(event.x_root, event.y_root)
            self.latest_event = (event.x, event.y)
        finally:
            self.menu.grab_release()


class FigureClickmenu(Clickmenu):
    """Copy/save options for a matplotlib figure canvas."""

    OPTIONS = {"png": ("Portable Network Graphics", "*.png"),
               "svg": ("Scalable Vector Graphics", "*.svg")}

    def __init__(self, window, master, canvas, widget):
        super().__init__(window, master, target_widget=widget)
        self.canvas = canvas
        self.menu.add_command(label="Copy", command=self.copy_fig)
        self.menu.add_command(label="Save as PNG",
                              command=partial(self.save_fig, "png"))
        self.menu.add_command(label="Save as SVG",
                              command=partial(self.save_fig, "svg"))

    def figure_png_bytes(self, dpi=300):
        with BytesIO() as buf:
            self.canvas.figure.savefig(buf, dpi=dpi, format="png")
            return buf.getvalue()

    def copy_fig(self):
        backend = _clipboard_backend()
        if backend is None:
            raise NotImplementedError(
                "Figure clipboard copy needs xclip or wl-copy on this "
                "platform")
        cmd, label = backend
        subprocess.run(cmd, input=self.figure_png_bytes(), check=True)
        if hasattr(self.window, "set_status"):
            self.window.set_status(f"Figure copied to clipboard ({label})")

    def save_fig(self, ftype, fname=None):
        if fname is None:
            from tkinter import filedialog
            fname = filedialog.asksaveasfilename(
                filetypes=[self.OPTIONS[ftype]], title="Save as")
        if not fname:
            return None
        if not fname.endswith(f".{ftype}"):
            fname += f".{ftype}"
        self.canvas.figure.savefig(fname)
        if hasattr(self.window, "set_status"):
            self.window.set_status(f"Saved figure to {fname}")
        return fname
