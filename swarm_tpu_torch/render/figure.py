"""Publication-style session figure (swarm_tpu/render/figure.py) — the
reference's static renderer
(simulation_tools/render_bedroom_map.py:53-173) for any session directory:
per-bot point clouds + trajectories, start/end markers, territory split
labels, separation annotation; saved as a PNG via matplotlib (offline
tooling — the hot rendering path is render/raster2d.py)."""

from __future__ import annotations

from typing import Optional


def render_session_figure(session_dir: str, out_path: Optional[str] = None,
                          title: str = "Dual-Robot Collaborative Mapping",
                          dpi: int = 200) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from swarm_tpu_torch.proto.csvio import load_session

    sess = load_session(session_dir)
    pts = sess["points"]
    agents = np.unique(sess["agent"])
    colors = ["#ff7859", "#5ac8ff", "#aaff78", "#ffd250", "#dc82ff"]

    fig, ax = plt.subplots(figsize=(11, 7), facecolor="#0f1218")
    ax.set_facecolor("#0f1218")

    for k, a in enumerate(agents):
        c = colors[k % len(colors)]
        if pts is not None:
            m = pts["agent"] == a
            ax.scatter(pts["x"][m], pts["y"][m], s=2.5, c=c, alpha=0.55,
                       label=f"Bot {a} point cloud")
        m = sess["agent"] == a
        ax.plot(sess["x"][m], sess["y"][m], c=c, lw=0.9, alpha=0.9)
        ax.plot(sess["x"][m][0], sess["y"][m][0], marker="o", ms=9, c=c,
                mec="white")
        ax.plot(sess["x"][m][-1], sess["y"][m][-1], marker="X", ms=10, c=c,
                mec="white")
        # territory label at the bot's cloud centroid (ref :150-160)
        if pts is not None and m.sum():
            mm = pts["agent"] == a
            if mm.sum():
                ax.text(float(np.median(pts["x"][mm])),
                        float(pts["y"][mm].max()) + 0.25,
                        f"BOT {a} TERRITORY", color=c, fontsize=10,
                        ha="center", weight="bold", alpha=0.9)

    # separation annotation between the first two bots' starts (ref :163-170)
    if len(agents) >= 2:
        s0 = sess["agent"] == agents[0]
        s1 = sess["agent"] == agents[1]
        x0, y0 = sess["x"][s0][0], sess["y"][s0][0]
        x1, y1 = sess["x"][s1][0], sess["y"][s1][0]
        sep = float(np.hypot(x1 - x0, y1 - y0))
        if sep > 0.5:
            ax.annotate("", xy=(x1, y1 - 0.4), xytext=(x0, y0 - 0.4),
                        arrowprops=dict(arrowstyle="<->", color="#9aa4b5"))
            ax.text((x0 + x1) / 2, y0 - 0.62, f"{sep:.1f} m separation",
                    color="#9aa4b5", ha="center", fontsize=9)

    ax.set_title(title, color="white", fontsize=14, pad=12)
    ax.set_xlabel("x [m]", color="#9aa4b5")
    ax.set_ylabel("y [m]", color="#9aa4b5")
    ax.tick_params(colors="#9aa4b5")
    for s in ax.spines.values():
        s.set_color("#39404d")
    ax.grid(color="#232a36", lw=0.5)
    ax.set_aspect("equal")
    leg = ax.legend(loc="upper right", facecolor="#161b24",
                    labelcolor="white", framealpha=0.9)
    leg.get_frame().set_edgecolor("#39404d")

    if out_path is None:
        out_path = f"{session_dir}/session_figure.png"
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight",
                facecolor=fig.get_facecolor())
    plt.close(fig)
    return out_path


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--session", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--title", default="Dual-Robot Collaborative Mapping")
    args = ap.parse_args(argv)
    print(render_session_figure(args.session, args.out, args.title))


if __name__ == "__main__":
    main()
