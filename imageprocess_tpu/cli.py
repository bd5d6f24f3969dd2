"""Command-line entrypoints — the rebuild of the reference's ``.bat`` menus
(1Intensity.bat / 2FocalAdhesion.bat / 3FRET.bat launchers, SURVEY §L0).

    imageprocess intensity  <folder> --channels 2 3 [...]
    imageprocess morphology <folder> --px-um 0.223 --channel 1 [...]
    imageprocess fret       <folder> --donor-ch 1 --acceptor-ch 2 [...]
    imageprocess nesprin2   <folder> --donor-ch 1 --fret-ch 2 [...]
    imageprocess fa         <img_dir> --roi-dir R --out O [...]
    imageprocess fa-tune    <img_dir> --roi-dir R --out O [...]
    imageprocess crop       <folder> --channel 1 [...]
    imageprocess roi-auto   <folder> [--backend threshold|cellpose] [...]
    imageprocess refine     <folder> [--thr 90] [...]
    imageprocess draw       <folder> [--timelapse]
    imageprocess ppt        <png_folder> [--width-cm 2.0]

All commands accept ``--lang en|ko`` or the reference's ``-mode EN`` flag.
GUI defaults from the reference are the CLI defaults (SURVEY §5 config).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .core import i18n


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--lang", default=None, choices=["en", "ko"])
    p.add_argument("--out", default=None, help="output root (default <folder>/RES*)")
    p.add_argument("--timelapse", action="store_true")
    p.add_argument("--xprof", default=None, metavar="DIR",
                   help="capture a jax profiler trace to DIR")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="imageprocess",
        description=i18n.t("app_title"),
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("intensity", help="per-ROI fluorescence intensity (Fluor_INT)")
    p.add_argument("folder")
    p.add_argument("--channels", type=int, nargs="+", default=[1])
    p.add_argument("--bg-mode", default="percentile",
                   choices=["percentile", "hist-mode", "none"])
    p.add_argument("--bg-scope", default="full", choices=["full", "roi_union"])
    p.add_argument("--percentile", type=float, default=1.0)
    p.add_argument("--per-channel-p", nargs="*", default=[], metavar="CH=P",
                   help="per-channel BG percentile overrides, e.g. 2=1 3=0.5")
    p.add_argument("--bg-stride", type=int, default=4)
    p.add_argument("--no-clip-neg", action="store_true")
    p.add_argument("--colors", nargs="*", default=[],
                   help="ch=Color pairs, e.g. 2=Green 3=Red")
    p.add_argument("--tif", action="store_true")
    p.add_argument("--png", action="store_true")
    p.add_argument("--raw-crop-tif", action="store_true")
    p.add_argument("--tif-mask-outside", action="store_true")
    p.add_argument("--no-xls", action="store_true")
    p.add_argument("--px-um", type=float, default=None)
    p.add_argument("--auto-lo", type=float, default=1.0,
                   help="display-range low percentile (GUI auto min)")
    p.add_argument("--auto-hi", type=float, default=99.0)
    p.add_argument("--crop-size", type=int, default=500,
                   help="fixed crop side in px (GUI 32-8000)")
    p.add_argument("--no-fixed-crop", action="store_true")
    p.add_argument("--dpi", type=int, default=300)
    p.add_argument("--cmap", default=None,
                   help="pseudocolor PNGs with this colormap")
    p.add_argument("--colorbar", action="store_true")
    p.add_argument("--scalebar-um", type=float, default=None)
    p.add_argument("--subset-stage", type=int, default=None)
    p.add_argument("--subset-time", type=int, default=None)
    p.add_argument("--subset-roi", type=int, default=None)
    p.add_argument("--batched", action="store_true",
                   help="batch frames per device dispatch (tables only)")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="shard the batch axis over the first N devices "
                        "(data parallelism over the (stage, time) axis; "
                        "requires --batched; raises --batch-size to at "
                        "least 2 per device)")
    p.add_argument("--all-experiments", action="store_true",
                   help="treat FOLDER as a parent (e.g. ANA/) and run every "
                        "experiment subfolder containing TIFFs")
    _add_common(p)

    p = sub.add_parser("morphology", help="per-ROI shape metrics (MOR_by_ROI)")
    p.add_argument("folder")
    p.add_argument("--px-um", type=float, required=True)
    p.add_argument("--channel", type=int, default=1)
    p.add_argument("--include-no-channel", action="store_true")
    p.add_argument("--no-full", action="store_true")
    p.add_argument("--no-crop", action="store_true")
    p.add_argument("--mask-outside", action="store_true")
    p.add_argument("--scalebar-um", type=float, default=None)
    p.add_argument("--mpl-canvas", action="store_true",
                   help="exact reference crop-PNG geometry (fixed 1100-px "
                        "canvas) instead of the default 2x upscale cap")
    _add_common(p)

    p = sub.add_parser("fret", help="two-channel ratiometric FRET (fret_ratio_builder)")
    p.add_argument("folder")
    p.add_argument("--donor-ch", type=int, default=1)
    p.add_argument("--acceptor-ch", type=int, default=2)
    p.add_argument("--ratio-mode", default="FRET/Donor",
                   choices=["FRET/Donor", "Donor/FRET"])
    p.add_argument("--percentile", type=float, default=1.0)
    p.add_argument("--donor-p", type=float, default=None,
                   help="donor-channel BG percentile (enables per-channel p)")
    p.add_argument("--fret-p", type=float, default=None)
    p.add_argument("--eps-percentile", type=float, default=1.0)
    p.add_argument("--eps-abs", type=float, default=5.0)
    p.add_argument("--bg-scope", default="full", choices=["full", "roi_union"])
    p.add_argument("--tif", action="store_true")
    p.add_argument("--png", action="store_true")
    p.add_argument("--no-xls", action="store_true")
    p.add_argument("--no-mask-outside", action="store_true",
                   help="keep pixels outside the ROI in crop PNGs")
    p.add_argument("--no-cmap", action="store_true")
    p.add_argument("--cmap", default="jet")
    p.add_argument("--no-colorbar", action="store_true")
    p.add_argument("--cmin", default="", help="fixed color min ('' = auto)")
    p.add_argument("--cmax", default="")
    p.add_argument("--dpi", type=int, default=300)
    p.add_argument("--crop-w", type=int, default=500)
    p.add_argument("--crop-h", type=int, default=500)
    p.add_argument("--scalebar-um", type=float, default=None)
    p.add_argument("--subset-stage", type=int, default=None)
    p.add_argument("--subset-time", type=int, default=None)
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="shard the batched tables path over the first N "
                        "devices (raises --batch-size to at least 2 per "
                        "device)")
    _add_common(p)

    p = sub.add_parser("nesprin2", help="nuclear-rim FRET (Nesprin2_FRET_Builder)")
    p.add_argument("folder")
    p.add_argument("--batched", action="store_true",
                   help="streaming batched tables runner (one fused device "
                        "dispatch per chunk of pairs; image outputs fall "
                        "back to the serial runner)")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="shard the batched pair axis over the first N "
                        "devices (implies --batched; raises --batch-size to "
                        "at least 2 per device)")
    p.add_argument("--donor-ch", type=int, default=1)
    p.add_argument("--fret-ch", type=int, default=2)
    p.add_argument("--intensity-ch", type=int, default=3)
    p.add_argument("--aonly-ch", type=int, default=None)
    p.add_argument("--px-um", type=float, default=0.112)
    p.add_argument("--rim-um", type=float, default=0.45)
    p.add_argument("--rim-preset", choices=["thin", "medium", "thick"], default=None)
    p.add_argument("--annulus", action="store_true")
    p.add_argument("--ann-in-um", type=float, default=1.2)
    p.add_argument("--ann-out-um", type=float, default=2.5)
    p.add_argument("--spectral", action="store_true")
    p.add_argument("--alpha", type=float, default=0.0)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--g-factor", type=float, default=1.0)
    p.add_argument("--sat-threshold", type=float, default=None)
    p.add_argument("--clip-ratio-max", type=float, default=None)
    p.add_argument("--ratio-mode", default="FRET/Donor",
                   choices=["FRET/Donor", "Donor/FRET"])
    p.add_argument("--bg-mode", default="percentile",
                   choices=["percentile", "hist-mode", "none"])
    p.add_argument("--bg-scope", default="full",
                   choices=["full", "roi_union", "annulus"])
    p.add_argument("--percentile", type=float, default=1.0)
    p.add_argument("--donor-p", type=float, default=None,
                   help="donor-channel BG percentile (enables per-channel p)")
    p.add_argument("--fret-p", type=float, default=None)
    p.add_argument("--eps-percentile", type=float, default=1.0)
    p.add_argument("--eps-abs", type=float, default=5.0)
    p.add_argument("--tif", action="store_true")
    p.add_argument("--png", action="store_true")
    p.add_argument("--panel", action="store_true",
                   help="write the 2-up ratio/intensity panel PNG")
    p.add_argument("--no-xls", action="store_true")
    p.add_argument("--subset-stage", type=int, default=None)
    p.add_argument("--subset-time", type=int, default=None)
    _add_common(p)

    p = sub.add_parser("fa", help="focal-adhesion detection (FA_Analyzer batch)")
    p.add_argument("img_dir")
    p.add_argument("--roi-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--channel", type=int, default=0)
    p.add_argument("--px-size", type=float, default=0.112)
    p.add_argument("--alpha", type=float, default=3.0)
    p.add_argument("--min-area-um", type=float, default=1.5)
    p.add_argument("--max-area-um", type=float, default=30.0)
    p.add_argument("--close-radius", type=int, default=1)
    p.add_argument("--no-subtract-bg", action="store_true")
    p.add_argument("--ok-only", action="store_true")
    p.add_argument("--max-fa-per-cell", type=int, default=256)
    p.add_argument("--master-name", default="FA_Results_Master.xlsx")
    p.add_argument("--no-master", action="store_true",
                   help="skip the merged master workbook")
    p.add_argument("--figs", action="store_true",
                   help="write per-stage overview figures (BND_FA/fig)")
    p.add_argument("--mat-dir", default=None, metavar="DIR",
                   help="legacy MATLAB boundary dir: overlay magenta dashed "
                        "boundaries matched by stage tag in the --figs "
                        "output (FA_Analyzer 'Enable Legacy MATLAB Import')")
    p.add_argument("--export-crops", action="store_true",
                   help="write per-cell FA crop PNGs (crops_export/)")
    p.add_argument("--batched", action="store_true",
                   help="streaming batched runner: prefetch decode + one "
                        "fused device dispatch per chunk of stages")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="shard the batched stage axis over the first N "
                        "devices (implies --batched; raises --batch-size to "
                        "at least 2 per device)")
    p.add_argument("--lang", default=None, choices=["en", "ko"])

    p = sub.add_parser("fa-tune",
                       help="interactive per-cell FA tuning (FAAnalyzerApp)")
    p.add_argument("img_dir")
    p.add_argument("--roi-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--channel", type=int, default=0)
    p.add_argument("--px-size", type=float, default=0.112)
    p.add_argument("--alpha", type=float, default=3.0)
    p.add_argument("--mat-dir", default=None, metavar="DIR",
                   help="legacy MATLAB boundary dir: magenta dashed overlay "
                        "in the tuner, toggled with 'm'")
    p.add_argument("--lang", default=None, choices=["en", "ko"])

    p = sub.add_parser("crop", help="per-ROI channel crops (roi_channel_cropper)")
    p.add_argument("folder")
    p.add_argument("--roi-dir", default=None)
    p.add_argument("--channel", type=int, default=1)
    p.add_argument("--color", default="Grayscale")
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--low-cut", type=float, default=0.5)
    p.add_argument("--high-cut", type=float, default=0.5)
    p.add_argument("--mask-outside", action="store_true")
    p.add_argument("--tiff16", action="store_true")
    p.add_argument("--tiff-raw", action="store_true")
    p.add_argument("--no-png", action="store_true")
    p.add_argument("--crop-w", type=int, default=500)
    p.add_argument("--crop-h", type=int, default=500)
    p.add_argument("--no-fixed-crop", action="store_true")
    p.add_argument("--dpi", type=int, default=300)
    p.add_argument("--scalebar-um", type=float, default=None)
    p.add_argument("--subset-stage", type=int, default=None)
    p.add_argument("--subset-time", type=int, default=None)
    p.add_argument("--subset-roi", type=int, default=None)
    p.add_argument("--px-um", type=float, default=None)
    _add_common(p)

    p = sub.add_parser("roi-auto", help="automatic segmentation (ROI_auto_drawer)")
    p.add_argument("folder")
    p.add_argument("--backend", default="threshold",
                   choices=["threshold", "unet", "cellpose"])
    p.add_argument("--checkpoint", default=None,
                   help="U-Net checkpoint dir or name: 'golden' (same-prep "
                        "specialist, the default) | 'general' (cross-domain "
                        "generalist)")
    p.add_argument("--prob-threshold", type=float, default=0.5)
    p.add_argument("--channel", type=int, default=None)
    p.add_argument("--thr-mode", default="percentile",
                   choices=["percentile", "mean_std"])
    p.add_argument("--thr-percentile", type=float, default=90.0)
    p.add_argument("--thr-k", type=float, default=2.0)
    p.add_argument("--smooth-sigma", type=float, default=2.0)
    p.add_argument("--min-size-px", type=int, default=200)
    p.add_argument("--diameter", type=float, default=None)
    p.add_argument("--model-type", default="cyto3")
    p.add_argument("--gpu", action="store_true")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="segment N frames at once, one per device "
                        "(unet backend only; results identical)")
    _add_common(p)

    p = sub.add_parser("refine", help="refine rough ROIs (roi_manual_drawer core)")
    p.add_argument("folder")
    p.add_argument("--thr", type=float, default=90.0)
    p.add_argument("--mode", default="percentile", choices=["percentile", "bnd"])
    p.add_argument("--min-area", type=float, default=40.0)
    p.add_argument("--tolerance", type=float, default=1.0)
    p.add_argument("--channel", type=int, default=None)
    _add_common(p)

    p = sub.add_parser(
        "draw",
        help="interactive ROI annotator (roi_manual_drawer)",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=(
            "keys (reference roi_manual_drawer.py:1095-1141, 1273-1275):\n"
            "  p          draw a rough polygon (auto-segmented inside)\n"
            "  u          undo last ROI          c  clear all ROIs\n"
            "  x          delete ROI at cursor   r  redraw ROI at cursor\n"
            "  a / d      display floor -/+ 1%   s / f  display ceil -/+ 1%\n"
            "  g / G      gamma -/+ 0.1          i  invert\n"
            "  0-5        pseudocolor: gray/cyan/blue/green/red/yellow\n"
            "  v          reset view (reference 'r'; 'r' here redraws)\n"
            "  e/b/n/o    toggle CLAHE / bandpass / unsharp / Sobel edges\n"
            "  tab / shift+tab  cycle channel    q  save & close"
        ))
    p.add_argument("folder")
    p.add_argument("--timelapse", action="store_true")
    p.add_argument("--lang", default=None, choices=["en", "ko"])

    p = sub.add_parser("ppt", help="FRET timelapse deck (Make_FRET_timelapsePPT)")
    p.add_argument("folder")
    p.add_argument("--width-cm", type=float, default=2.0)
    p.add_argument("--lang", default=None, choices=["en", "ko"])

    p = sub.add_parser("doctor",
                       help="environment self-check (native tier, numerics, "
                            "backend reachability under a timeout, mesh)")
    p.add_argument("--backend-timeout", type=float, default=600.0,
                   help="seconds before a backend probe that has not "
                        "answered is reported as FAIL")
    p.add_argument("--skip-backend", action="store_true",
                   help="skip the device-backend probe")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print one machine-readable JSON object instead "
                        "of per-check lines")
    p.add_argument("--lang", default=None, choices=["en", "ko"])
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # the reference's "-mode EN" flag (Fluor_INT.py:244-254)
    lang = i18n.pick_lang_from_argv(argv)
    argv = [a for i, a in enumerate(argv)
            if a != "-mode" and not (i > 0 and argv[i - 1] == "-mode")]
    args = build_parser().parse_args(argv)
    if getattr(args, "lang", None):
        lang = args.lang
    i18n.set_lang(lang)
    log = print
    log(i18n.t("run_start"))
    from .utils.profiling import maybe_profile

    try:
        with maybe_profile(getattr(args, "xprof", None)):
            return _dispatch(args, log)
    finally:
        log(i18n.t("run_end"))


def _mesh_for(args, log):
    """Validate ``--devices`` against the available device count and build
    the 1-D mesh the batched runners shard over (the reference's worker-
    count spinbox, Fluor_INT.py:2211-2213).  Returns ``(ok, mesh)`` — ok
    is False when the request exceeds the hardware (callers exit 1);
    mesh is None for single-device runs."""
    if args.devices <= 1:
        return True, None
    import jax

    from .parallel.runner import make_mesh

    n_avail = len(jax.devices())
    if args.devices > n_avail:
        log(i18n.t("cli_devices_error").format(n=args.devices,
                                               avail=n_avail))
        return False, None
    return True, make_mesh(args.devices)


def _parse_ch_map(specs, value_type, flag: str, shape: str) -> dict:
    """CH=VALUE pair lists (--colors, --per-channel-p): friendly SystemExit
    on a malformed spec instead of a raw int()/float() traceback."""
    out = {}
    for spec in specs:
        ch, eq, val = spec.partition("=")
        try:
            if not eq:
                raise ValueError
            out[int(ch)] = value_type(val)
        except ValueError:
            raise SystemExit(f"{flag} expects {shape} pairs (got {spec!r})")
    return out


def _dispatch(args, log) -> int:
    if args.cmd == "intensity":
        from .pipelines.intensity import IntensityConfig, run_intensity

        from .report.panel import PanelPngOptions

        colors = _parse_ch_map(args.colors, str, "--colors", "CH=COLOR")
        per_p = _parse_ch_map(args.per_channel_p, float, "--per-channel-p",
                              "CH=P")
        panel = PanelPngOptions(
            cmap_on=args.cmap is not None, cmap=args.cmap or "jet",
            colorbar=args.colorbar, scalebar_um=args.scalebar_um,
            dpi=args.dpi,
        )
        cfg = IntensityConfig(
            channels=tuple(args.channels), timelapse=args.timelapse,
            bg_mode=args.bg_mode, bg_scope=args.bg_scope,
            percentile=args.percentile, per_channel_p=per_p,
            bg_stride=args.bg_stride,
            clip_neg=not args.no_clip_neg, channel_colors=colors,
            do_xls=not args.no_xls,
            do_tif=args.tif, do_png=args.png, px_um=args.px_um,
            save_raw_crop_tif=args.raw_crop_tif,
            tif_mask_outside=args.tif_mask_outside,
            auto_lo=args.auto_lo, auto_hi=args.auto_hi,
            fixed_crop=not args.no_fixed_crop, crop_size=args.crop_size,
            png_full=panel, png_crop=panel,
            subset_stage=args.subset_stage, subset_time=args.subset_time,
            subset_roi=args.subset_roi,
        )
        import os

        from .core.naming import list_tifs

        folders = [args.folder]
        if args.all_experiments:
            folders = sorted(
                os.path.join(args.folder, d)
                for d in os.listdir(args.folder)
                if os.path.isdir(os.path.join(args.folder, d))
                and list_tifs(os.path.join(args.folder, d))
            )
            if not folders:
                log("[warn] no experiment subfolders with TIFFs")
                return 1
        rows = []
        for folder in folders:
            if len(folders) > 1:
                log(i18n.t("cli_experiment").format(folder=folder))
            # multi-experiment runs with an explicit --out write each
            # experiment under <out>/<experiment_name> (an --out shared by
            # all experiments would overwrite; silently ignoring it loses
            # the user's requested location)
            out_root = args.out
            if out_root is not None and len(folders) > 1:
                out_root = os.path.join(out_root, os.path.basename(folder))
            if args.batched or args.devices > 1:
                # --devices implies --batched (same as nesprin2/fa);
                # silently running the serial single-device path would
                # drop the user's sharding request
                from .core.runlog import RunLogger
                from .pipelines.intensity import run_intensity_batched

                ok, mesh = _mesh_for(args, log)
                if not ok:
                    return 1
                # L8 parity on the production path: RES/logs/run_*.txt
                # with [START]/[END] stamps, like the serial runner
                res_root = out_root or os.path.join(folder, "RES")
                logger = RunLogger(os.path.join(res_root, "logs"), echo=log)
                try:
                    rows += run_intensity_batched(folder, cfg,
                                                  out_root=out_root,
                                                  log=logger, mesh=mesh)
                finally:
                    logger.close()
            else:
                rows += run_intensity(folder, cfg, out_root=out_root, log=log,
                                      run_log=True, progress=True)
        log(i18n.t("progress").format(done=len(rows), total=len(rows)))
        return 0

    if args.cmd == "morphology":
        from .pipelines.morphology import MorConfig, run_morphology

        cfg = MorConfig(
            px_um=args.px_um, sel_ch=args.channel,
            include_no_channel=args.include_no_channel,
            timelapse=args.timelapse, save_full=not args.no_full,
            save_crop=not args.no_crop, mask_outside=args.mask_outside,
            add_scalebar=args.scalebar_um is not None,
            scale_bar_um=args.scalebar_um, mpl_canvas=args.mpl_canvas,
        )
        run_morphology(args.folder, cfg, out_root=args.out, log=log)
        return 0

    if args.cmd == "fret":
        from .pipelines.fret import FretConfig, run_fret_batched

        per_ch = args.donor_p is not None or args.fret_p is not None
        cfg = FretConfig(
            donor_ch=args.donor_ch, acceptor_ch=args.acceptor_ch,
            timelapse=args.timelapse, ratio_mode=args.ratio_mode,
            percentile=args.percentile,
            per_channel_p=per_ch,
            donor_p=args.donor_p if args.donor_p is not None else args.percentile,
            fret_p=args.fret_p if args.fret_p is not None else args.percentile,
            eps_percentile=args.eps_percentile, eps_abs=args.eps_abs,
            bg_scope=args.bg_scope, do_tif=args.tif, do_png=args.png,
            do_xls=not args.no_xls,
            mask_outside=not args.no_mask_outside,
            apply_cmap=not args.no_cmap, cmap_name=args.cmap,
            show_colorbar=not args.no_colorbar,
            cmin_txt=args.cmin, cmax_txt=args.cmax, png_dpi=args.dpi,
            crop_w=args.crop_w, crop_h=args.crop_h,
            add_scalebar=args.scalebar_um is not None,
            scale_bar_um=args.scalebar_um,
            subset_stage=args.subset_stage, subset_time=args.subset_time,
        )
        ok, mesh = _mesh_for(args, log)
        if not ok:
            return 1
        # tables-only runs take the minimum-transfer batched path;
        # image outputs fall back to the rendering runner automatically
        run_fret_batched(args.folder, cfg, out_root=args.out, log=log,
                         mesh=mesh)
        return 0

    if args.cmd == "nesprin2":
        from .pipelines.nesprin2 import (
            RIM_PRESETS, Nesprin2Config, run_nesprin2, run_nesprin2_batched,
        )

        rim_um, ann_in, ann_out = args.rim_um, args.ann_in_um, args.ann_out_um
        if args.rim_preset:
            rim_um, ann_in, ann_out = RIM_PRESETS[args.rim_preset]
        per_ch = args.donor_p is not None or args.fret_p is not None
        cfg = Nesprin2Config(
            donor_ch=args.donor_ch, fret_ch=args.fret_ch,
            intensity_ch=args.intensity_ch, aonly_ch=args.aonly_ch,
            timelapse=args.timelapse, px_um=args.px_um, rim_um=rim_um,
            ratio_mode=args.ratio_mode, bg_mode=args.bg_mode,
            bg_scope=args.bg_scope, percentile=args.percentile,
            per_channel_p=per_ch,
            donor_p=args.donor_p if args.donor_p is not None else args.percentile,
            fret_p=args.fret_p if args.fret_p is not None else args.percentile,
            eps_percentile=args.eps_percentile, eps_abs=args.eps_abs,
            annulus_on=args.annulus, ann_in_um=ann_in, ann_out_um=ann_out,
            use_spectral=args.spectral, alpha=args.alpha, beta=args.beta,
            g_factor=args.g_factor,
            sat_filter_on=args.sat_threshold is not None,
            # `or` would turn an explicit 0 into the default
            sat_threshold=(args.sat_threshold
                           if args.sat_threshold is not None else 65535.0),
            clip_ratio_on=args.clip_ratio_max is not None,
            clip_ratio_max=(args.clip_ratio_max
                            if args.clip_ratio_max is not None else 10.0),
            do_tif=args.tif, do_png=args.png, do_xls=not args.no_xls,
            save_panel=args.panel,
            subset_stage=args.subset_stage, subset_time=args.subset_time,
        )
        if args.batched or args.devices > 1:
            ok, mesh = _mesh_for(args, log)
            if not ok:
                return 1
            run_nesprin2_batched(args.folder, cfg, out_root=args.out,
                                 log=log, mesh=mesh)
        else:
            run_nesprin2(args.folder, cfg, out_root=args.out, log=log)
        return 0

    if args.cmd == "fa":
        from .pipelines.fa import FaConfig, run_fa_batch, run_fa_batched

        cfg = FaConfig(
            channel=args.channel, px_size=args.px_size, alpha=args.alpha,
            min_area_um=args.min_area_um, max_area_um=args.max_area_um,
            close_radius=args.close_radius,
            subtract_bg=not args.no_subtract_bg, save_ok_only=args.ok_only,
            max_fa_per_cell=args.max_fa_per_cell,
            do_master_report=not args.no_master,
            master_name=args.master_name,
        )
        if args.batched or args.devices > 1:
            ok, mesh = _mesh_for(args, log)
            if not ok:
                return 1
            run_fa_batched(args.img_dir, args.roi_dir, args.out, cfg,
                           log=log, mesh=mesh)
        else:
            run_fa_batch(args.img_dir, args.roi_dir, args.out, cfg, log=log)
        if args.figs:
            from .pipelines.fa import save_fa_figs

            save_fa_figs(args.img_dir, args.roi_dir, args.out, cfg,
                         mat_dir=args.mat_dir, log=log)
        if args.export_crops:
            from .pipelines.fa import export_fa_crops

            export_fa_crops(args.img_dir, args.roi_dir, args.out, cfg, log=log)
        return 0

    if args.cmd == "fa-tune":
        from .apps.fa_tune import main as fa_tune_main
        from .pipelines.fa import FaConfig

        fa_tune_main(args.img_dir, args.roi_dir, args.out,
                     FaConfig(channel=args.channel, px_size=args.px_size,
                              alpha=args.alpha),
                     mat_dir=args.mat_dir, log=log)
        return 0

    if args.cmd == "crop":
        import os

        from .pipelines.crop import CropConfig, run_crop

        cfg = CropConfig(
            channel=args.channel, timelapse=args.timelapse, color=args.color,
            gamma=args.gamma, low_cut=args.low_cut, high_cut=args.high_cut,
            mask_outside=args.mask_outside, save_png=not args.no_png,
            save_tiff16=args.tiff16, save_tiff_raw=args.tiff_raw,
            fixed_crop=not args.no_fixed_crop,
            crop_w=args.crop_w, crop_h=args.crop_h, png_dpi=args.dpi,
            add_scalebar=args.scalebar_um is not None,
            sb_len_um=args.scalebar_um,
            subset_stage=args.subset_stage, subset_time=args.subset_time,
            subset_roi=args.subset_roi,
            px_um=args.px_um,
        )
        roi_dir = args.roi_dir or os.path.join(args.folder, "roi")
        out = args.out or os.path.join(args.folder, "RES_CROP")
        run_crop(args.folder, roi_dir, out, cfg, log=log)
        return 0

    if args.cmd == "roi-auto":
        from .segment.auto import AutoSegConfig, run_auto_drawer

        ok, _ = _mesh_for(args, log)
        if not ok:
            return 1
        cfg = AutoSegConfig(
            backend=args.backend, channel=args.channel,
            timelapse=args.timelapse, thr_mode=args.thr_mode,
            thr_percentile=args.thr_percentile, thr_k=args.thr_k,
            smooth_sigma=args.smooth_sigma, min_size_px=args.min_size_px,
            checkpoint=args.checkpoint, prob_threshold=args.prob_threshold,
            diameter=args.diameter, model_type=args.model_type,
            use_gpu=args.gpu, devices=args.devices,
        )
        run_auto_drawer(args.folder, cfg, roi_dir=args.out, log=log)
        return 0

    if args.cmd == "refine":
        from .segment.drawer import RefineConfig, refine_and_save

        cfg = RefineConfig(
            thr_param=args.thr, mode=args.mode, min_area=args.min_area,
            tolerance=args.tolerance, channel=args.channel,
            timelapse=args.timelapse,
        )
        refine_and_save(args.folder, cfg, roi_dir=args.out, log=log)
        return 0

    if args.cmd == "draw":
        from .apps.draw import main as draw_main

        draw_main(args.folder, timelapse=args.timelapse, log=log)
        return 0

    if args.cmd == "ppt":
        from .pipelines.fretppt import run_fret_ppt

        ok, _ = run_fret_ppt(args.folder, args.width_cm, log=log)
        return 0 if ok else 1

    if args.cmd == "doctor":
        from .utils.doctor import run_doctor

        return run_doctor(backend_timeout=args.backend_timeout,
                          skip_backend=args.skip_backend,
                          as_json=args.as_json, log=log)

    return 2


if __name__ == "__main__":
    raise SystemExit(main())
