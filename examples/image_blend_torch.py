"""Paper Listing 1, verbatim, in PyTorch: progressive image blend in the
MISO textual language (the port's ``examples/image_blend.py``).

The source below is the paper's example program (ImageBlend +
StaticImage).  It is parsed by the port's MISO front end
(``src/repro_torch/core/ir.py``), dependencies are extracted from the
transition expressions, and the compiled program runs on the same
executors as the LM stack.  The runtime loads the two "images" (paper:
"loading input and output data can be performed by the runtime") and
streams intermediate states out -- the paper's video-animation output,
rendered here as ASCII frames.

Run:  PYTHONPATH=src python examples/image_blend_torch.py            # on cuda
      PYTHONPATH=src python examples/image_blend_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch import api as miso

W, H = 24, 12
N = W * H

SOURCE = """
// paper Listing 1 (image size reduced for the terminal)
cell ImageBlend {
  var r:Float = 0;
  var g:Float = 0;
  var b:Float = 0;

  transition {
    r = .99 * r + .01 * image2(this.pos).r;
    g = .99 * g + .01 * image2(this.pos).g;
    b = .99 * b + .01 * image2(this.pos).b;
  }
}
cell StaticImage {
  var r:Float = 0;
  var g:Float = 0;
  var b:Float = 0;
}
image1 = new ImageBlend(%d)
image2 = new StaticImage(%d)
""" % (N, N)

RAMP = " .:-=+*#%@"


def make_image(kind: str) -> dict:
    """Runtime-side input loading: two synthetic RGB images."""
    y, x = np.mgrid[0:H, 0:W]
    if kind == "rings":
        v = (np.hypot(x - W / 2, y - H / 2) % 6 < 3) * 255.0
    else:
        v = ((x // 3 + y // 3) % 2) * 255.0
    return {"r": v.reshape(-1), "g": (255 - v).reshape(-1), "b": v.reshape(-1) * 0.5}


def ascii_frame(state) -> str:
    lum = (state["r"] + state["g"] + state["b"]).cpu().numpy().reshape(H, W)
    lum = lum / max(lum.max(), 1e-9)
    return "\n".join("".join(RAMP[int(v * (len(RAMP) - 1))] for v in row) for row in lum)


def main(argv=None) -> list:
    """Blend and print the frames; returns them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = ap.parse_args(argv)
    img1, img2 = make_image("rings"), make_image("checker")
    program = miso.compile_source(SOURCE, inputs={"image1": img1, "image2": img2})
    program.validate()

    # one front door for the textual language too: the parsed program
    # compiles to the same executors as the LM stack
    exe = miso.compile(program, backend="lockstep", device=ns.device)
    states = exe.init(0)

    # the runtime streams intermediate states (the paper's "video" output)
    frames, shown = (0, 60, 240, 600), []
    total = 0
    for upto in frames:
        n = upto - total
        if n:
            states = exe.run(states, n).states
            total = upto
        shown.append(ascii_frame(states["image1"]))
        print(f"\n--- transition {total} ---")
        print(shown[-1])

    # convergence check: after many transitions image1 -> image2
    err = float(np.abs(states["image1"]["r"].cpu().numpy() - img2["r"]).mean())
    expect = 0.99 ** total * np.abs(img1["r"] - img2["r"]).mean()
    print(f"\nmean |image1.r - image2.r| after {total} transitions: {err:.2f} "
          f"(0.99^{total} of initial contrast ~ {expect:.2f})")
    assert abs(err - expect) < 0.05 * expect + 1e-3

    # the dependency extractor saw exactly what the paper promises
    g = program.graph()
    reads = {c.name: list(c.reads) for c in program.cells.values()}
    print("\nextracted reads:", reads)
    print("dependency components (wavefront units):", g.condensation()[0])
    assert reads == {"image1": ["image2"], "image2": []}
    return shown


if __name__ == "__main__":
    main()
