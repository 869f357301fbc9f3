"""Matplotlib slice viewer for solution and geometry fields.

Equivalent of the reference GUI's PlotField/PlotWidget postprocessing tabs
(fibergen_gui.py:525-1616): field/component/slice selectors, colormaps,
contrast (alpha quantile clipping), custom bounds, bicubic interpolation and
PNG/VTK export.  Works headless (Agg) and interactively (sliders/radio
buttons when a display is available).

The fields come to the host as numpy arrays (``FG.get_field`` gathers them
from the card); matplotlib is imported only by the rendering and export
methods, so a headless run (:meth:`SliceViewer.from_fg`,
:meth:`SliceViewer.current_slice`, :func:`list_demos`) needs none.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

FIELD_LABELS = {
    "epsilon": "strain",
    "sigma": "stress",
    "phi": "phase",
    "u": "displacement",
    "p": "pressure",
    "distance": "distance",
    "normals": "normals",
    "orientation": "orientation",
}


class SliceViewer:
    """Views (ncomp, nx, ny, nz) fields as 2D slices."""

    def __init__(self, fields: Dict[str, np.ndarray], grid=None):
        self.fields = {k: np.asarray(v) for k, v in fields.items()}
        if not self.fields:
            raise ValueError(
                "no viewable fields: run a load case (or init the solver) "
                "before opening the viewer")
        self.grid = grid
        self.field = next(iter(self.fields))
        self.component = 0
        self.slice_dim = "z"
        self.slice_index = 0.5
        self.colormap = "jet"     # the reference's defaultColormap
        self.alpha = 0.0          # contrast quantile clipping
        self.custom_bounds: Optional[tuple] = None
        self.interpolate = False
        # depth mode (fibergen_gui.py:716-732, 1296-1331): composite the
        # phi field over remaining depth with exponential attenuation
        # max(data * exp(-3 z / depth)) — an X-ray-like projection.  Like
        # the reference, the composite only applies to the phi field.
        self.depth_view = False
        self.extra_fields: list = []

    @classmethod
    def from_fg(cls, fg, names=("epsilon", "sigma", "phi")):
        """Build a viewer from a solved FG, honoring the project's <view>
        settings exactly like the reference GUI (lib/fibergen_gui.py:3047-
        3246 reads field/slice_dim/slice_index/custom_bounds/vmin/vmax/
        alpha/interpolate/extra_fields)."""
        names = list(names)
        view = None
        try:
            view = fg.project.root.find("view")
        except Exception:  # noqa: BLE001 - no project loaded
            view = None

        def v(tag, default=None):
            if view is None:
                return default
            e = view.find(tag)
            return e.text.strip() if e is not None and e.text else default

        extra = v("extra_fields")
        extra_list = ([s.strip() for s in extra.split(",") if s.strip()]
                      if extra else [])
        names += extra_list

        fields = {}
        for n in names:
            base = n.rstrip("0123456789")
            try:
                fields.setdefault(base, fg.get_field(base))
            except Exception:  # noqa: BLE001 - optional fields
                continue
        self = cls(fields, grid=fg.solver.grid if fg.solver else None)

        fld = v("field")
        if fld:
            base = fld.rstrip("0123456789")
            if base in self.fields:
                self.field = base
                comp = fld[len(base):]
                if comp:
                    self.component = int(comp)
        if v("slice_dim"):
            self.slice_dim = v("slice_dim")
        if v("slice_index") is not None:
            self.slice_index = float(v("slice_index"))
        if v("alpha") is not None:
            self.alpha = float(v("alpha"))
        if v("interpolate") is not None:
            self.interpolate = v("interpolate") not in ("0", "false")
        if v("custom_bounds") not in (None, "0", "false"):
            lo = float(v("vmin", 0.0))
            hi = float(v("vmax", 1.0))
            self.custom_bounds = (lo, hi)
        if v("colormap"):
            self.colormap = v("colormap")
        if v("depth_view") is not None:
            self.depth_view = v("depth_view") not in ("0", "false")
        self.extra_fields = extra_list
        return self

    # ------------------------------------------------- view <-> XML (Embed)
    def view_xml(self) -> str:
        """Serialize the current view back into a `<view>` XML block — the
        reference's Embed toolbar action (getViewXML,
        fibergen_gui.py:944-1032): non-default settings only, so the block
        stays minimal and round-trips through :meth:`from_fg`."""
        import xml.etree.ElementTree as ET
        view = ET.Element("view")

        def sub(tag, text):
            e = ET.SubElement(view, tag)
            e.text = str(text)

        comp = "" if self.component == 0 else str(self.component)
        sub("field", f"{self.field}{comp}")
        sub("slice_dim", self.slice_dim)
        sub("slice_index", repr(float(self.slice_index)))
        if self.colormap != "jet":
            sub("colormap", self.colormap)
        if self.alpha != 0.0:
            sub("alpha", repr(float(self.alpha)))
        if self.interpolate:
            sub("interpolate", 1)
        if self.depth_view:
            sub("depth_view", 1)
        if self.custom_bounds is not None:
            sub("custom_bounds", 1)
            sub("vmin", repr(float(self.custom_bounds[0])))
            sub("vmax", repr(float(self.custom_bounds[1])))
        if self.extra_fields:
            sub("extra_fields", ",".join(self.extra_fields))
        indent = "\t"
        view.text = "\n" + indent
        for e in view:
            e.tail = "\n" + indent
        e.tail = "\n"
        return ET.tostring(view, encoding="unicode")

    # ------------------------------------------------------------- slicing
    def current_slice(self) -> np.ndarray:
        f = self.fields[self.field]
        c = min(self.component, f.shape[0] - 1)
        vol = f[c]
        ax = {"x": 0, "y": 1, "z": 2}[self.slice_dim]
        idx = int(round(self.slice_index * (vol.shape[ax] - 1)))
        if self.depth_view and self.field == "phi":
            # depth composite from the slice to the far boundary with
            # exponential attenuation exp(-3 z / depth) (getCurrentSlice,
            # fibergen_gui.py:1296-1331; like the reference, phi only)
            depth = vol.shape[ax]
            data = np.take(vol, range(idx, vol.shape[ax]), axis=ax)
            z = np.indices(data.shape)[ax]
            return np.max(data * np.exp((-3.0 / depth) * z), axis=ax)
        sl = np.take(vol, idx, axis=ax)
        return sl

    def bounds(self, sl) -> tuple:
        if self.custom_bounds is not None:
            return self.custom_bounds
        if self.alpha > 0:
            lo = np.quantile(sl, self.alpha)
            hi = np.quantile(sl, 1 - self.alpha)
        else:
            lo, hi = float(sl.min()), float(sl.max())
        if hi <= lo:
            hi = lo + 1e-30
        return lo, hi

    # ------------------------------------------------------------ rendering
    def render(self, ax=None):
        """Draw the current slice on a matplotlib axes (created if None)."""
        import matplotlib.pyplot as plt
        if ax is None:
            _, ax = plt.subplots()
        sl = self.current_slice()
        lo, hi = self.bounds(sl)
        im = ax.imshow(sl.T, origin="lower", cmap=self.colormap,
                       vmin=lo, vmax=hi,
                       interpolation="bicubic" if self.interpolate else "nearest")
        ax.set_title(f"{self.field}[{self.component}] "
                     f"{self.slice_dim}-slice @ {self.slice_index:.2f}")
        # figure-scoped colorbar (works for embedded Qt canvases where the
        # figure is not pyplot-managed)
        ax.figure.colorbar(im, ax=ax)
        return ax

    def save_png(self, path: str):
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        self.render(ax)
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)

    def save_vtk(self, path: str):
        from ..io.vtk import write_vtk
        if self.grid is None:
            raise ValueError("no grid attached")
        write_vtk(path, self.grid, self.fields)

    def save_plot_export(self, path: str):
        """Colormapped PNG of the current slice PLUS a standalone pgfplots
        .tex wrapper with the active colormap serialized as 256 rgb255
        entries — the reference's publication-export path
        (fibergen_gui.py:1144-1215 + gui/plot_template.tex, re-derived).
        Returns (png_path, tex_path)."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        base = path[:-4] if path.endswith((".png", ".tex")) else path
        png_path, tex_path = base + ".png", base + ".tex"

        sl = self.current_slice()
        lo, hi = self.bounds(sl)
        cmap = matplotlib.colormaps[self.colormap]
        data = np.clip((np.rot90(sl.T) - lo) / (hi - lo or 1e-30), 0.0, 1.0)
        rgba = cmap(data)
        matplotlib.image.imsave(png_path, rgba)

        import os
        cm_lines = "\n".join(
            "  rgb255=(%d, %d, %d);" % tuple(
                int(v * 255.99) for v in cmap(c)[:3])
            for c in np.linspace(0.0, 1.0, 256))
        label = FIELD_LABELS.get(self.field, self.field)
        png_name = os.path.basename(png_path)
        tex = f"""% generated by fibergen_tpu_torch: colormapped slice export
\\documentclass{{standalone}}
\\usepackage{{pgfplots}}
\\pgfplotsset{{compat=1.16}}
\\begin{{document}}
\\begin{{tikzpicture}}
\\begin{{axis}}[enlargelimits=false, axis on top, colorbar,
  colormap={{embedded}}{{
{cm_lines}
  }},
  point meta min={lo!r}, point meta max={hi!r},
  colorbar style={{ylabel={{{label}[{self.component}]}}}}]
\\addplot graphics [xmin=0, xmax={sl.shape[0]}, ymin=0,
  ymax={sl.shape[1]}] {{{png_name}}};
\\end{{axis}}
\\end{{tikzpicture}}
\\end{{document}}
"""
        with open(tex_path, "w") as f:
            f.write(tex)
        return png_path, tex_path

    # ---------------------------------------------------------- interactive
    def show(self):
        """Interactive viewer with sliders (requires a display)."""
        import matplotlib.pyplot as plt
        from matplotlib.widgets import RadioButtons, Slider

        fig, ax = plt.subplots()
        fig.subplots_adjust(left=0.3, bottom=0.2)
        self.render(ax)

        ax_slice = fig.add_axes([0.3, 0.05, 0.55, 0.03])
        s_slice = Slider(ax_slice, "slice", 0.0, 1.0, valinit=self.slice_index)

        ax_field = fig.add_axes([0.02, 0.4, 0.2, 0.3])
        r_field = RadioButtons(ax_field, list(self.fields.keys()))

        def update(_):
            self.slice_index = s_slice.val
            self.field = r_field.value_selected
            ax.clear()
            sl = self.current_slice()
            lo, hi = self.bounds(sl)
            ax.imshow(sl.T, origin="lower", cmap=self.colormap,
                      vmin=lo, vmax=hi)
            fig.canvas.draw_idle()

        s_slice.on_changed(update)
        r_field.on_clicked(update)
        plt.show()


def embed_view_xml(xml_text: str, view_block: str) -> str:
    """Insert or replace the `<view>` block in a project XML string — the
    editor half of the reference's Embed action (saveCurrentView,
    fibergen_gui.py:1033-1058): an existing `<view>...</view>` region is
    replaced in place, otherwise the block is inserted before
    `</settings>`."""
    import re
    indent = "\t"
    sub = "\n".join(indent + ln for ln in view_block.split("\n"))
    m = re.search(r"[ \t]*<view>.*?</view>[ \t]*", xml_text, flags=re.S)
    pre, post = "\n", "\n"
    if m is None:
        m = re.search(r"\s*</settings>", xml_text)
        if m is None:
            return xml_text + pre + sub + "\n"
        post = "\n\n</settings>\n"
    return xml_text[:m.start()] + pre + sub + post + xml_text[m.end():]


def list_demos(demo_dir: str):
    """Demo browser data: scan demo/ categories (DemoWidgetCommon,
    fibergen_gui.py:2381-2682)."""
    import os
    import xml.etree.ElementTree as ET
    cats = []
    for cat in sorted(os.listdir(demo_dir)):
        cdir = os.path.join(demo_dir, cat)
        if not os.path.isdir(cdir):
            continue
        entry = {"name": cat, "title": cat, "projects": []}
        cxml = os.path.join(cdir, "category.xml")
        if os.path.exists(cxml):
            try:
                entry["title"] = ET.parse(cxml).getroot().get("title", cat)
            except ET.ParseError:
                pass
        for proj in sorted(os.listdir(cdir)):
            pdir = os.path.join(cdir, proj)
            for fn in ("project.xml", "project.py"):
                path = os.path.join(pdir, fn)
                if os.path.exists(path):
                    title = proj
                    if fn.endswith(".xml"):
                        try:
                            t = ET.parse(path).getroot().find("title")
                            if t is not None and t.text:
                                title = t.text.strip()
                        except ET.ParseError:
                            pass
                    entry["projects"].append(
                        {"name": proj, "title": title, "path": path})
        if entry["projects"]:
            cats.append(entry)
    return cats
