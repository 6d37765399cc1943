"""Documentation build system (VERDICT r3 #4).

The reference ships a Sphinx tree (~50 rst files with autodoc API pages,
/root/reference/docs/source/). Sphinx/mkdocs are not installed in this
image, so this script provides the same two capabilities with the stdlib +
the available ``markdown``/``pygments`` packages:

1. ``--api``: generate one markdown API-reference page per public class
   plus grouped pages (functions, plots, presets, gui, parallel,
   global_options) into ``docs/api/`` by introspecting the live package —
   the autodoc analog. The generated pages are committed so the API
   reference is readable in the repo without a build step.
2. ``--html``: render the whole ``docs/`` markdown tree (hand-written +
   generated) into a static HTML site at ``docs/_build/html`` with a
   sidebar navigation and pygments-highlighted code blocks.

CI-style entry point (both phases):

    python tools/build_docs.py

Exit code is nonzero on any generation/render failure, so the command
doubles as the docs gate.
"""

import html
import inspect
import os
import re
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(REPO, "docs")
API = os.path.join(DOCS, "api")
BUILD = os.path.join(DOCS, "_build", "html")

# the docs build runs on the in-process CPU backend (it needs no card):
# re-exec with JAX_PLATFORMS=cpu before jax initializes, if needed
if "jax" in sys.modules or os.environ.get("JAX_PLATFORMS") != "cpu":
    env = dict(os.environ, JAX_PLATFORMS="cpu", MPLBACKEND="Agg")
    os.execve(sys.executable, [sys.executable] + [os.path.abspath(__file__)]
              + sys.argv[1:], env)

sys.path.insert(0, REPO)


# ---------------------------------------------------------------------------
# phase 1: API reference generation


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    return inspect.getdoc(obj) or ""


def _member_section(cls) -> str:
    """Markdown for the public methods/properties of one class."""
    out = []
    members = inspect.getmembers(cls)

    init = cls.__dict__.get("__init__") or cls.__init__
    if init is not object.__init__:
        out.append(f"### `{cls.__name__}{_sig(init)}`\n")
        if _doc(init):
            out.append(_doc(init) + "\n")

    props = [(n, m) for n, m in members
             if isinstance(m, property) and not n.startswith("_")]
    meths = [(n, m) for n, m in members
             if (inspect.isfunction(m) or inspect.ismethod(m))
             and not n.startswith("_") and n not in ("__init__",)]

    if meths:
        out.append("\n## Methods\n")
        for n, m in meths:
            out.append(f"### `{n}{_sig(m)}`\n")
            if _doc(m):
                out.append(_doc(m) + "\n")
    if props:
        out.append("\n## Properties\n")
        for n, m in props:
            out.append(f"### `{n}`\n")
            if _doc(m.fget) if m.fget else "":
                out.append(_doc(m.fget) + "\n")

    # documented class attributes (simple scalars/lists only)
    attrs = [(k, v) for k, v in vars(cls).items()
             if not k.startswith("_") and not callable(v)
             and not isinstance(v, (property, classmethod, staticmethod))
             and isinstance(v, (int, float, str, bool, list, tuple))]
    if attrs:
        out.append("\n## Class attributes\n")
        for k, v in attrs:
            r = repr(v)
            out.append(f"- `{k} = {r if len(r) <= 100 else r[:97] + '...'}`")
        out.append("")
    return "\n".join(out)


def _class_page(cls, qualname: str) -> str:
    head = (f"# {cls.__name__}\n\n`{qualname}`"
            f" — bases: {', '.join(b.__name__ for b in cls.__bases__)}\n\n")
    return head + (_doc(cls) + "\n\n" if _doc(cls) else "") + _member_section(cls)


def _callables_page(title: str, intro: str, items) -> str:
    out = [f"# {title}\n", intro + "\n"]
    for qual, fn in items:
        out.append(f"## `{qual}{_sig(fn)}`\n")
        if _doc(fn):
            out.append(_doc(fn) + "\n")
    return "\n".join(out)


def generate_api() -> list:
    import optrace_tpu as ot
    from optrace_tpu.gui import (TraceGUI, CommandWindow, PropertyBrowser,
                                 ScenePlotting)
    from optrace_tpu.gui.interactors import (SidePanel, MousePicking,
                                             KeyboardShortcuts)
    from optrace_tpu import plots, parallel
    from optrace_tpu.parallel import render as prender
    from optrace_tpu.parallel import checkpoint as pcheckpoint
    from optrace_tpu.utils import global_options as go_mod

    os.makedirs(API, exist_ok=True)
    for f in os.listdir(API):
        os.remove(os.path.join(API, f))

    pages = []   # (filename, title, markdown)

    classes = sorted(
        (n, getattr(ot, n)) for n in dir(ot)
        if not n.startswith("_") and inspect.isclass(getattr(ot, n)))
    for n, cls in classes:
        pages.append((f"{n}.md", n, _class_page(cls, f"optrace_tpu.{n}")))

    for n, cls in [("TraceGUI", TraceGUI), ("ScenePlotting", ScenePlotting),
                   ("CommandWindow", CommandWindow),
                   ("PropertyBrowser", PropertyBrowser),
                   ("SidePanel", SidePanel), ("MousePicking", MousePicking),
                   ("KeyboardShortcuts", KeyboardShortcuts)]:
        pages.append((f"gui_{n}.md", f"gui.{n}",
                      _class_page(cls, f"optrace_tpu.gui.{n}")))

    pages.append(("functions.md", "Top-level functions", _callables_page(
        "Top-level functions", "Free functions exported by `optrace_tpu`.",
        [(f"optrace_tpu.{n}", getattr(ot, n)) for n in dir(ot)
         if not n.startswith("_") and inspect.isfunction(getattr(ot, n))])))

    pages.append(("plots.md", "plots", _callables_page(
        "optrace_tpu.plots", _doc(plots) or "Plotting entry points.",
        [(f"plots.{n}", getattr(plots, n)) for n in sorted(dir(plots))
         if not n.startswith("_") and callable(getattr(plots, n))])))

    pages.append(("parallel.md", "parallel", _callables_page(
        "optrace_tpu.parallel",
        (_doc(parallel) or "") + "\n\nFused/sharded render factories and "
        "checkpointing for multi-chip runs.",
        [(f"parallel.render.{n}", getattr(prender, n))
         for n in sorted(dir(prender))
         if not n.startswith("_") and inspect.isfunction(getattr(prender, n))]
        + [(f"parallel.checkpoint.{n}", getattr(pcheckpoint, n))
           for n in sorted(dir(pcheckpoint))
           if not n.startswith("_")
           and inspect.isfunction(getattr(pcheckpoint, n))])))

    go_cls = type(ot.global_options)
    pages.append(("global_options.md", "global_options",
                  _class_page(go_cls, "optrace_tpu.global_options")))

    # presets: list every preset name per submodule
    lines = ["# Presets\n", _doc(ot.presets) or ""]
    for sub in sorted(dir(ot.presets)):
        if sub.startswith("_"):
            continue
        mod = getattr(ot.presets, sub)
        if not inspect.ismodule(mod):
            continue
        names = [n for n in dir(mod) if not n.startswith("_")]
        lines.append(f"\n## presets.{sub}\n")
        if _doc(mod):
            lines.append(_doc(mod) + "\n")
        for n in names:
            o = getattr(mod, n)
            if inspect.ismodule(o):
                continue
            if inspect.isfunction(o):
                lines.append(f"- `{n}{_sig(o)}`"
                             + (f" — {_doc(o).splitlines()[0]}" if _doc(o) else ""))
            else:
                d = getattr(o, "desc", "") or getattr(o, "quantity", "")
                lines.append(f"- `{n}`" + (f" — {d}" if d else ""))
    pages.append(("presets.md", "Presets", "\n".join(lines)))

    # index page
    idx = ["# API reference\n",
           "Generated by `python tools/build_docs.py --api` from the live "
           "package (the reference ships the analogous Sphinx autodoc "
           "pages, `/root/reference/docs/source/reference/`).\n",
           "\n## Classes\n"]
    for fname, title, _ in pages:
        if fname[0].isupper():
            idx.append(f"- [{title}]({fname.replace('.md', '.html')})")
    idx.append("\n## GUI\n")
    for fname, title, _ in pages:
        if fname.startswith("gui_"):
            idx.append(f"- [{title}]({fname.replace('.md', '.html')})")
    idx.append("\n## Modules and functions\n")
    for fname, title, _ in pages:
        if not fname[0].isupper() and not fname.startswith("gui_"):
            idx.append(f"- [{title}]({fname.replace('.md', '.html')})")
    pages.append(("index.md", "API reference", "\n".join(idx)))

    for fname, _, text in pages:
        with open(os.path.join(API, fname), "w") as f:
            f.write(text if text.endswith("\n") else text + "\n")
    return pages


# ---------------------------------------------------------------------------
# phase 2: HTML site


CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 0; color: #1a1a1a; }
.layout { display: flex; min-height: 100vh; }
nav { width: 270px; background: #f5f6f8; padding: 18px 14px; font-size: 13px;
      border-right: 1px solid #ddd; flex-shrink: 0; }
nav a { color: #205080; text-decoration: none; display: block;
        padding: 1.5px 0 1.5px 8px; }
nav a:hover { text-decoration: underline; }
nav .sect { font-weight: 600; margin-top: 12px; color: #333; }
main { padding: 26px 40px; max-width: 880px; min-width: 0; }
code { background: #f2f2f2; padding: 1px 4px; border-radius: 3px;
       font-size: 0.92em; }
pre { background: #f8f8f8; border: 1px solid #e4e4e4; border-radius: 5px;
      padding: 10px 12px; overflow-x: auto; }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; }
td, th { border: 1px solid #ccc; padding: 4px 9px; font-size: 13.5px; }
h1, h2, h3 { scroll-margin-top: 10px; }
h1 { border-bottom: 2px solid #e0e0e0; padding-bottom: 6px; }
img { max-width: 100%; }
"""


def _nav_tree(md_files) -> str:
    """Sidebar listing grouped by directory."""
    groups = {}
    for rel in md_files:
        d = os.path.dirname(rel) or "."
        groups.setdefault(d, []).append(rel)
    order = sorted(groups, key=lambda d: (d != ".", d))
    out = []
    for d in order:
        label = {".": "Guide", "usage": "Usage", "physics": "Physics",
                 "api": "API reference"}.get(d, d)
        out.append(f'<div class="sect">{html.escape(label)}</div>')
        for rel in sorted(groups[d], key=lambda r: (not r.endswith("index.md"), r)):
            href = rel[:-3] + ".html"
            name = os.path.basename(rel)[:-3]
            out.append(f'<a href="/{href}">{html.escape(name)}</a>')
    return "\n".join(out)


def build_html() -> int:
    import markdown

    md_files = []
    for root, dirs, files in os.walk(DOCS):
        if "_build" in root:
            continue
        for f in sorted(files):
            if f.endswith(".md"):
                md_files.append(os.path.relpath(os.path.join(root, f), DOCS))

    if os.path.isdir(BUILD):
        shutil.rmtree(BUILD)
    os.makedirs(BUILD, exist_ok=True)

    # static assets (gallery images etc.) copied verbatim
    for root, dirs, files in os.walk(DOCS):
        if "_build" in root:
            continue
        for f in files:
            if f.lower().endswith((".png", ".jpg", ".svg", ".gif")):
                srcp = os.path.join(root, f)
                dstp = os.path.join(BUILD, os.path.relpath(srcp, DOCS))
                os.makedirs(os.path.dirname(dstp), exist_ok=True)
                shutil.copy2(srcp, dstp)

    nav = _nav_tree(md_files)

    try:
        from pygments.formatters import HtmlFormatter
        pyg_css = HtmlFormatter().get_style_defs(".codehilite")
    except Exception:
        pyg_css = ""
    with open(os.path.join(BUILD, "style.css"), "w") as f:
        f.write(CSS + "\n" + pyg_css)

    n_err = 0
    for rel in md_files:
        src = os.path.join(DOCS, rel)
        dst = os.path.join(BUILD, rel[:-3] + ".html")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            text = open(src).read()
            body = markdown.markdown(
                text, extensions=["fenced_code", "tables", "codehilite", "toc"],
                extension_configs={"codehilite": {"guess_lang": False}})
            # .md links -> .html links within the site
            body = re.sub(r'href="([^"]+)\.md"', r'href="\1.html"', body)
            depth = rel.count(os.sep)
            cssrel = "../" * depth + "style.css"
            navlocal = nav.replace('href="/', 'href="' + "../" * depth)
            title = os.path.basename(rel)[:-3]
            page = (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
                    f"<title>{html.escape(title)} — optrace_tpu</title>"
                    f"<link rel='stylesheet' href='{cssrel}'></head><body>"
                    f"<div class='layout'><nav>{navlocal}</nav>"
                    f"<main>{body}</main></div></body></html>")
            with open(dst, "w") as f:
                f.write(page)
        except Exception as e:
            print(f"ERROR rendering {rel}: {e!r}", file=sys.stderr)
            n_err += 1
    print(f"built {len(md_files) - n_err}/{len(md_files)} pages -> {BUILD}")
    return n_err


def main() -> int:
    do_api = "--html" not in sys.argv or "--api" in sys.argv
    do_html = "--api" not in sys.argv or "--html" in sys.argv
    if do_api:
        pages = generate_api()
        print(f"generated {len(pages)} API pages -> {API}")
    if do_html:
        return build_html()
    return 0


if __name__ == "__main__":
    sys.exit(main())
