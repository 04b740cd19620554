"""Standardized GUI palette and widget style kwargs.

Parity module for the reference's ``GUI/gui_colors.py`` + ``GUI/gui_styles.py``
(same color values and kwarg contracts); applied by ``Window`` and the popups
so the whole shell themes consistently.
"""


def rgb(r: int, g: int, b: int) -> str:
    return f"#{r:02x}{g:02x}{b:02x}"


WHITE = rgb(255, 255, 255)
LIGHT_GREY = rgb(191, 191, 191)
GREY = rgb(127, 127, 127)
DARK_GREY = rgb(63, 63, 63)
BLACK = rgb(0, 0, 0)
RED = rgb(127, 0, 0)
GREEN = rgb(0, 127, 0)


def plot_color_cycle():
    """Matplotlib's active prop cycle (reference PLOT_COLOR_CYCLE) —
    resolved lazily so importing this module never pulls in matplotlib."""
    from matplotlib.pyplot import rcParams
    return rcParams["axes.prop_cycle"].by_key()["color"]


# kwargs for common widget classes (reference gui_styles.py contract)
MENU_KWARGS = {"width": 10, "background": BLACK,
               "highlightbackground": BLACK, "foreground": WHITE}
LABEL_KWARGS = {"width": 14, "background": LIGHT_GREY}
PANEL_KWARGS = {"background": LIGHT_GREY}
