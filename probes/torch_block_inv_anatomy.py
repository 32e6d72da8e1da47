"""What sets the batched block inverse's time on a CUDA card: the SASS of
its kernel, and timed variants with one part of the work knocked out.

    python3 probes/torch_block_inv_anatomy.py [--source FILE ...]
        [--f 9] [--batch 2501] [--shapes 2501x9,4096x7,...]

Each ``--source`` (default: ``gmpnp_tpu_torch/csrc/block_inv.cu``; give
another checkout's file to dissect its kernel) is compiled as
``gmpnp_tpu_torch/ops/_build.py`` compiles it (``nvcc -O3`` for
``sm_90a``, ``-Xptxas -v``), and once more for each knock-out that
applies to its text.  A knock-out is a text substitution; its results are
wrong and only its time is read:

- ``no_div``: each quotient by the pivot becomes a product;
- ``no_clamp``: the range clamp returns its argument (and a deferred
  clamp never runs);
- ``no_search``: no candidate ever takes the pivot from row k;
- ``no_shfl``: a thread takes column k's values from its own registers,
  not from the column's owner.

Per library the script prints the registers, spills and local memory of
the f64 kernel at ``--f`` (from ``ptxas``), its SASS opcode counts
(``cuobjdump -sass``; the kernel is unrolled over the f column steps, so
the count over f is the count per step; the whole listing goes to
``build/anatomy/<label>.sass``) and its device time per launch at
(batch, f, f) f64 on seeded normal blocks: hot (one operand, re-read from
L2) and cold (a rotation over >= 256 MB of copies), each from a replayed
CUDA graph (``chip_smoke.graph_us``), in turns: every library in order,
then in reverse order, and the mean of the two.  A source whose C entry
takes the blocks each warp inverts (``blocks_per_warp``) runs at the
package's choice (``ops.block_inv.blocks_per_warp``), and its unmodified
kernel is then timed the same way at every ``--shapes`` entry (batch x
f, f64) for every blocks-per-warp count from 1 to 32 // f.  The card's
name and power limit come first.  Build products go under
``build/anatomy/``.
"""

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "build", "anatomy")
DEFAULT_SOURCE = os.path.join(ROOT, "gmpnp_tpu_torch", "csrc", "block_inv.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared")
#: (name, [(pattern, replacement), ...]): a knock-out applies to a source
#: when at least one of its patterns matches there
KNOCKOUTS = [
    ("no_div", [(r"div_rn\((\w+(?:\[k\])?), piv\)", r"mul_rn(\1, piv)"),
                (r"pivot_quotients\(([^,]+), ([^,]+), piv(?:, [^,]+)?, rl, rr\);",
                 r"rl = (\1) * piv;\n    rr = (\2) * piv;")]),
    ("no_clamp", [(r"(clamp_range\((?:T|double|float) x\) \{)",
                   r"\1\n  return x;"),
                  (r"if \(over\) \{", "if (false) {")]),
    ("no_search", [(r"if \(col == k\) \{", "if (false) {"),
                   (r"if \(takes_pivot\(val\[i \+ s\], val\[i\]\)\) \{",
                    "if (false) {")]),
    ("no_shfl", [(r"__shfl_sync\(kFull, (\w)\[i\], owner\)", r"\1[i]")]),
]
OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_]*)")


def variants(path):
    """(label, source text) of the source and of every knock-out that
    applies to it."""
    text = open(path).read()
    tag = os.path.basename(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(path)))))
    out = [(f"{tag}:full", text)]
    for name, subs in KNOCKOUTS:
        changed, hits = text, 0
        for pattern, repl in subs:
            changed, n = re.subn(pattern, repl, changed)
            hits += n
        if hits:
            out.append((f"{tag}:{name}", changed))
    return out


def build_all(labelled):
    """Compile every (label, text) in parallel; returns label -> (library
    path, ptxas log)."""
    os.makedirs(OUT, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    jobs = {}
    for i, (label, text) in enumerate(labelled):
        src = os.path.join(OUT, f"v{i}.cu")
        with open(src, "w") as fh:
            fh.write(text)
        lib = os.path.join(OUT, f"v{i}.so")
        jobs[label] = (lib, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for label, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        built[label] = (lib, log)
    return built


def ptxas_lines(log, f):
    """ptxas' lines about the f64 kernel at f."""
    lines = log.splitlines()
    want = f"block_inv_kernelIdLi{f}E"
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and want in line:
            return " | ".join(x.strip() for x in lines[i + 1:i + 4]
                              if "ptxas info" in x)
    return "not found"


def sass_counts(lib, f, dump):
    """Opcode -> count in the f64 kernel at f, whose listing is written to
    ``dump``."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    want = f"block_inv_kernelIdLi{f}E"
    counts, inside, listing = collections.Counter(), False, []
    for line in sass.splitlines():
        if "Function :" in line:
            inside = want in line
        elif inside:
            listing.append(line)
            m = OPCODE.search(line)
            if m and m.group(1) != "NOP":
                counts[m.group(1)] += 1
    with open(dump, "w") as fh:
        fh.write("\n".join(listing))
    return counts


def takes_blocks_per_warp(text):
    return "int blocks_per_warp" in text


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--source", action="append", default=None)
    p.add_argument("--f", type=int, default=9)
    p.add_argument("--batch", type=int, default=2501)
    p.add_argument("--shapes", default="2501x9,2501x7,4096x7,4096x5,12288x7")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("anatomy: no CUDA device", file=sys.stderr)
        return 1
    from gmpnp_tpu_torch.ops.block_inv import blocks_per_warp

    print(chip_smoke.card_line(), flush=True)
    labelled = [v for src in (args.source or [DEFAULT_SOURCE])
                for v in variants(src)]
    texts = dict(labelled)
    built = build_all(labelled)
    rng = np.random.default_rng(9)
    fns = {}
    for label, (lib, log) in built.items():
        fn = ctypes.CDLL(lib).block_inv_f64
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int]
                       + [ctypes.c_int] * takes_blocks_per_warp(texts[label])
                       + [ctypes.c_void_p])
        fns[label] = fn
        counts = sass_counts(lib, args.f, os.path.join(
            OUT, f"{label.replace(':', '_')}.sass"))
        total = sum(counts.values())
        print(f"anatomy {label}: ptxas {ptxas_lines(log, args.f)}",
              flush=True)
        print(f"anatomy {label}: sass {total} instructions "
              f"({total / args.f!r} per column step) "
              f"{dict(counts.most_common())}", flush=True)

    def timed(runs, batch, f):
        """{run label: (hot, cold)} at (batch, f, f) f64, in turns; a run
        is (library label, blocks per warp or None)."""
        A = torch.as_tensor(rng.normal(size=(batch, f, f)),
                            dtype=torch.float64, device="cuda")
        copies = chip_smoke._copies(A)
        mats = [A] + [A.clone() for _ in range(copies - 1)]
        out = torch.empty_like(A)

        def call(run, m):
            label, per_warp = run
            extra = () if per_warp is None else (per_warp,)
            err = fns[label](m.data_ptr(), out.data_ptr(), batch, f, *extra,
                             torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{run}: CUDA error {err}")

        times = collections.defaultdict(list)
        for order in (runs, runs[::-1]):
            for run in order:
                hot = chip_smoke.graph_us([lambda run=run: call(run, A)])
                cold = chip_smoke.graph_us(
                    [lambda run=run, i=i: call(run, mats[i])
                     for i in range(copies)])
                times[run].append((hot, cold))
        return {run: tuple(float(np.mean(v)) for v in zip(*turns))
                for run, turns in times.items()}

    f = args.f
    runs = [(label, blocks_per_warp(f) if takes_blocks_per_warp(
        texts[label]) else None) for label in fns]
    for (label, per_warp), (hot, cold) in timed(runs, args.batch,
                                                 f).items():
        print(f"anatomy {label}: ({args.batch}, {f}, {f}) f64 "
              f"blocks_per_warp={per_warp} hot_us={hot!r} "
              f"cold_us={cold!r}", flush=True)
    full = [label for label in fns
            if label.endswith(":full") and takes_blocks_per_warp(
                texts[label])]
    for shape in args.shapes.split(",") if full else ():
        batch, f = map(int, shape.split("x"))
        runs = [(label, g) for label in full for g in range(1, 32 // f + 1)]
        for (label, per_warp), (hot, cold) in timed(runs, batch, f).items():
            print(f"blocks per warp {label}: ({batch}, {f}, {f}) f64 "
                  f"blocks_per_warp={per_warp} hot_us={hot!r} "
                  f"cold_us={cold!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
