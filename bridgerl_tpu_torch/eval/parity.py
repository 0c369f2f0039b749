"""Quality-parity criteria vs the reference (BASELINE.md), evaluated on the
framework's own converged runs.

Counterpart of ``bridgerl_tpu/eval/parity.py``: the same criteria over the
same history JSONs and experiment JSONs, and the same PARITY.md text.

Absolute metric values cannot match the reference (its ModelScope dataset is
unreachable — zero egress; training here uses the synthetic generator), so
parity is defined by measurable, data-independent SIGNATURES of the method
zoo (round-2 VERDICT item 1):

  C1 cross-method recon ordering: hybrid/rvq << fsq <= ema <= simple
     (reference table README.md:344-362: 0.0120/0.0124 << 0.0317 < 0.0355
     < 0.0457)
  C2 FSQ and hybrid unique-code spread in the reference class: the logged
     DCR (= 1 - unique/nominal) must satisfy 0.5 <= unique/nominal <= 2.0,
     two-sided (reference: DCR 0.0, unique ~1.36x nominal, README.md:356)
  C3 hybrid PPL approaches the FSQ implicit-codebook capacity class
     (reference: 1096.8 of prod(8,5,5,5)=1000 nominal; PPL is the
     unique-code-count proxy, which can exceed the nominal size)
  C4 hybrid reports rvq_ppl (the auxiliary metric the reference's LaTeX
     exporter special-cases)
  C5 ae (IdentityVQ) is the reconstruction upper bound: its recon <= every
     quantized method's recon on the same arch/window
  C6 per-config convergence targets on this repo's own data (noise floor of
     the synthetic generator is ~2.5e-3 per dim for bottlenecked models;
     resnet_no_down+ae can pass noise through):
       - resnet_no_down + ae  W10: val_recon < 2e-3   (ref class: 5.4e-4)
       - transformer + hybrid W10: val_recon < 1.5e-2 (ref class: 7.5e-3)
       - transformer + hybrid W10 student: val_align < 1e-2 (ref: 4.0e-3)
  C7 flagship PPL stability: every flagship teacher seed ends with FSQ
     PPL > 200 (the round-1 seed-1024 collapse pinned it at 1.0; the
     reference is stable at 1096.8 +- 0.3 across seeds)
  C8 student cross-recon within 3x of teacher recon (ref ~1.06x)
  C9 LFQ learns: PPL >= 100 of 1024 (ref 164.2) and recon <= 8x the best
     method (ref 4.8x) — round-2 collapse criteria, fail until fixed
  C10 W64-era transformer teacher val_recon < 5.5e-2 (BASELINE row 5,
      ref 2.75e-2, threshold scaled 2x like C6)
  C11 W64-K4 two-stage teacher (the measured-best QUALITY recipe,
      scripts/specs_k4_2stage.json): best val_recon < 1e-2 (measured 0.0037)
  C12 K4 student cross-recon within 3x of the K4 teacher recon (measured
      1.02x — retargeting quality carries over to the K4 recipe)

Each criterion is computed from `results/log_*.json` by `evaluate_parity` and
rendered into PARITY.md by scripts/check_parity.py.

Generative-stack criteria (round-3 VERDICT weak #5: the prior had measured
yardsticks but no pass/fail row, so a regression would be silent). These are
REGRESSION BANDS around the measured round-3/4 results of the corpus-scaling
study (abruns/prior_scale_val, abruns/prior_scale2, docs/ROUND3.md), not
aspirational targets — the decode+stitch ceiling (vel 0.93 / overlap-dis
0.041) is documented next to each band:

  G1 generalization: every untagged scaling arm with >= 160 takes scores
     held-out prompted-continuation truth_mse BELOW its own val_nn_floor
     (what pure retrieval against the train bank could achieve; takes64
     fails this by design — memorization scale)
  G2 tokenizer health: recon_floor (frozen teacher's recon on unseen takes)
     <= 8e-3 on every arm (measured 0.0036-0.0039; 2x headroom)
  G3 prior learns beyond init: largest arm improves grouped-val CE by
     >= 0.5 nats from epoch 0 (measured 4.55 -> 3.28 at takes1280)
  G4 free-run dynamics bands at the largest arm: vel_ratio >= 0.15 and
     overlap_disagreement <= 0.30 (measured 0.22 / 0.17; ceiling 0.93 /
     0.041 — the open gap is tracked in docs, the band catches regressions)
  G5 conditioned control is sampler-level: histogram-match accuracy 1.0
     at perclass12 (the class token steers SAMPLING; its measured
     information gain is ~0 nats because the class is already inferable
     from the token prefix — adjudicated in docs/ROUND4.md)
  G6 guided continuation (adopted in docs/ROUND4.md): prompted P8 guided
     sampling scores >= 1.5x lower truth-MSE at offsets <= 3 AND lower seam
     disagreement than unguided (measured 2.9x / 0.161-vs-0.253)

Evaluated from the committed experiment JSONs by `evaluate_generation`.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .plots import load_and_aggregate


@dataclass
class Criterion:
    cid: str
    description: str
    passed: Optional[bool]  # None = not evaluable (missing runs)
    detail: str


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _final(metrics: Dict[str, List[list]], key: str, k: int = 5) -> Optional[float]:
    """Mean over seeds of last-k-epoch means (the exporter's statistic)."""
    if key not in metrics or not metrics[key]:
        return None
    return float(np.mean([np.mean(s[-k:]) for s in metrics[key]]))


def _best(metrics: Dict[str, List[list]], key: str) -> Optional[float]:
    if key not in metrics or not metrics[key]:
        return None
    return float(np.mean([np.min(s) for s in metrics[key]]))


def _student_bucket(data: Dict) -> Dict[str, List[list]]:
    """The flagship student's aggregated logs, whichever naming family the
    run used (id-style `transformer_hybrid_student` wins the tie; both
    families hold identical histories when the trainer wrote twin logs)."""
    return (data.get("transformer_hybrid_student")
            or data.get("Exp_transformer_W10_student") or {})


def evaluate_parity(log_dir: str = "results") -> List[Criterion]:
    data = load_and_aggregate(log_dir)
    crits: List[Criterion] = []

    def recon(exp_id):
        return _final(data.get(exp_id, {}), "val_recon")

    # ---- C1: cross-method recon ordering on the W64 grid ----
    hybrid, rvq = recon("resnet_hybrid"), recon("resnet_rvq")
    fsq, ema, simple = recon("resnet_fsq"), recon("resnet_ema"), recon("simple_ema")
    if None in (hybrid, rvq, fsq, ema, simple):
        crits.append(Criterion("C1", "recon ordering hybrid/rvq << fsq <= ema <= simple",
                               None, "grid runs missing"))
    else:
        strong = max(hybrid, rvq)
        ok = strong < 0.7 * fsq and fsq <= ema * 1.15 and ema <= simple * 1.15
        crits.append(Criterion(
            "C1", "recon ordering hybrid/rvq << fsq <= ema <= simple", ok,
            f"hybrid={hybrid:.4g} rvq={rvq:.4g} fsq={fsq:.4g} "
            f"ema={ema:.4g} simple={simple:.4g}"))

    # ---- C2: FSQ + hybrid unique-code spread in the reference class ----
    dcr_f = _final(data.get("resnet_fsq", {}), "dcr")
    dcr_h = _final(data.get("resnet_hybrid", {}), "dcr")
    if dcr_f is None or dcr_h is None:
        crits.append(Criterion("C2", "FSQ & hybrid unique/nominal in [0.5, 2.0]",
                               None, "grid runs missing"))
    else:
        # DCR is logged as 1 - unique/nominal; the unbounded-round FSQ can
        # exceed nominal capacity, so assert a TWO-SIDED band on the ratio:
        # the reference publishes DCR 0.0 with unique ~1.36x nominal
        # (README.md:356). The round-2 one-sided `dcr < 0.15` let a 4.2-4.6x
        # spread pass silently (VERDICT weak #2 / ADVICE) — this band fails
        # until the latent spread is in the reference class.
        r_f, r_h = 1.0 - dcr_f, 1.0 - dcr_h
        ok = 0.5 <= r_f <= 2.0 and 0.5 <= r_h <= 2.0
        crits.append(Criterion(
            "C2", "FSQ & hybrid unique/nominal in [0.5, 2.0] (ref 1.36)", ok,
            f"fsq ratio={r_f:.2f} hybrid ratio={r_h:.2f} "
            f"(dcr {dcr_f:.2f}/{dcr_h:.2f})"))

    # ---- C3: hybrid PPL near FSQ capacity class ----
    ppl_h = _final(data.get("resnet_hybrid", {}), "perplexity")
    if ppl_h is None:
        crits.append(Criterion("C3", "hybrid PPL in the FSQ-capacity class (>=500 of ~1000)",
                               None, "grid runs missing"))
    else:
        crits.append(Criterion("C3", "hybrid PPL in the FSQ-capacity class (>=500 of ~1000)",
                               ppl_h >= 500.0, f"hybrid ppl={ppl_h:.1f} (ref 1096.8)"))

    # ---- C4: hybrid reports rvq_ppl ----
    has_rvq_ppl = bool(data.get("resnet_hybrid", {}).get("rvq_ppl"))
    crits.append(Criterion("C4", "hybrid logs the auxiliary rvq_ppl metric",
                           has_rvq_ppl if data.get("resnet_hybrid") else None,
                           "present" if has_rvq_ppl else "absent"))

    # ---- C5: ae is the recon upper bound (flagship arch, W10) ----
    ae = _best(data.get("resnet_no_down_ae", {}), "val_recon")
    flag = _best(data.get("transformer_hybrid", {}), "val_recon")
    if ae is None or flag is None:
        crits.append(Criterion("C5", "ae (IdentityVQ) recon <= quantized recon",
                               None, "W10 runs missing"))
    else:
        crits.append(Criterion("C5", "ae (IdentityVQ) recon <= quantized recon",
                               ae <= flag,
                               f"resnet_no_down+ae={ae:.4g} <= transformer+hybrid={flag:.4g}"))

    # ---- C6: per-config convergence targets on own data ----
    targets = [
        ("resnet_no_down_ae", "val_recon", 2e-3, "resnet_no_down+ae W10 (ref 5.4e-4)"),
        ("transformer_hybrid", "val_recon", 1.5e-2, "transformer+hybrid W10 teacher (ref 7.5e-3)"),
        ("transformer_hybrid", "val_align", 1e-2, "transformer+hybrid W10 student (ref 4.0e-3)"),
    ]
    for i, (exp_id, key, thr, label) in enumerate(targets):
        # val_align must come from STUDENT runs only: teacher logs also carry
        # a val_align column (the untrained human branch, O(1)-large), so the
        # student families are consulted exclusively for that criterion
        if key == "val_align":
            v = _best(_student_bucket(data), key)
        else:
            v = _best(data.get(exp_id, {}), key)
        if v is None:
            crits.append(Criterion(f"C6.{i+1}", f"{label}: best {key} < {thr:g}",
                                   None, "run missing"))
        else:
            crits.append(Criterion(f"C6.{i+1}", f"{label}: best {key} < {thr:g}",
                                   v < thr, f"best {key}={v:.4g}"))

    # ---- C8: retargeting closes the loop — the student's cross-recon
    # (human -> robot decoder vs robot GT) must land in the teacher's recon
    # class (reference: cross 0.0127 vs recon 0.0120, ~1.06x) ----
    stud = _student_bucket(data)
    cross = _best(stud, "val_cross_recon")
    t_recon = _best(data.get("transformer_hybrid", {}), "val_recon")
    if cross is None or t_recon is None:
        crits.append(Criterion("C8", "student cross-recon within 3x of teacher recon",
                               None, "student/teacher runs missing"))
    else:
        crits.append(Criterion("C8", "student cross-recon within 3x of teacher recon",
                               cross <= 3.0 * t_recon,
                               f"cross={cross:.4g} vs teacher recon={t_recon:.4g}"))

    # ---- C9: LFQ learns (round-2 VERDICT item 3) — the reference's LFQ is
    # the worst quantizer but still trains: PPL 164.2±8.9 of 1024 and recon
    # ~4.8x the best method (README.md:357). Round-2 runs collapsed to
    # PPL 46 / recon 18.3x best; these criteria fail until LFQ is fixed. ----
    # Two-sided band (round-3 VERDICT weak #5): the one-sided >=100 was
    # degenerate — a UNIFORM random code stream (PPL ~ 1024) would pass.
    # The band rejects both collapse (<100) and uniform-noise usage (>1000);
    # C9.2's recon bound guards that the in-band usage actually learns.
    lfq_ppl = _final(data.get("resnet_lfq", {}), "perplexity")
    if lfq_ppl is None:
        crits.append(Criterion("C9.1", "LFQ PPL in [100, 1000] of 1024 (ref 164.2)",
                               None, "lfq runs missing"))
    else:
        crits.append(Criterion("C9.1", "LFQ PPL in [100, 1000] of 1024 (ref 164.2)",
                               100.0 <= lfq_ppl <= 1000.0,
                               f"lfq ppl={lfq_ppl:.1f}"))
    lfq_recon = _final(data.get("resnet_lfq", {}), "val_recon")
    best_recon = None
    cands = [recon(e) for e in ("resnet_hybrid", "resnet_rvq")]
    cands = [c for c in cands if c is not None]
    if cands:
        best_recon = min(cands)
    if lfq_recon is None or best_recon is None:
        crits.append(Criterion("C9.2", "LFQ recon <= 8x best method (ref 4.8x)",
                               None, "lfq/grid runs missing"))
    else:
        crits.append(Criterion("C9.2", "LFQ recon <= 8x best method (ref 4.8x)",
                               lfq_recon <= 8.0 * best_recon,
                               f"lfq={lfq_recon:.4g} vs best={best_recon:.4g} "
                               f"({lfq_recon / best_recon:.1f}x)"))

    # ---- C10: W64-era transformer teacher (BASELINE row 5; round-2 VERDICT
    # item 8). Reference val_recon 2.75e-2; threshold scaled 2x to own-data
    # difficulty like C6. ----
    w64 = _best(data.get("transformer_hybrid_W64", {}), "val_recon")
    if w64 is None:
        crits.append(Criterion("C10", "transformer+hybrid W64 teacher: best "
                               "val_recon < 5.5e-2 (ref 2.75e-2)",
                               None, "W64 transformer runs missing"))
    else:
        crits.append(Criterion("C10", "transformer+hybrid W64 teacher: best "
                               "val_recon < 5.5e-2 (ref 2.75e-2)",
                               w64 < 5.5e-2, f"best val_recon={w64:.4g}"))

    # ---- C11/C12: the QUALITY flagship — W64-K4 two-stage recipe (round-3
    # VERDICT weak #6 / next #8: the measured-best recipe was not
    # criterion-watched). Two-stage = 80-ep ae pretrain then hybrid with
    # codebook data init (scripts/specs_k4_2stage.json); cures the W64
    # cold-start collapse (0.32 mean-prediction floor -> 0.0037). ----
    k4 = _best(data.get("transformer_hybrid_W64_K4", {}), "val_recon")
    if k4 is None:
        crits.append(Criterion("C11", "W64-K4 two-stage teacher: best "
                               "val_recon < 1e-2 (measured 0.0037, 2x "
                               "better than K1)", None, "K4 runs missing"))
    else:
        crits.append(Criterion("C11", "W64-K4 two-stage teacher: best "
                               "val_recon < 1e-2 (measured 0.0037, 2x "
                               "better than K1)", k4 < 1e-2,
                               f"best val_recon={k4:.4g}"))
    k4s = data.get("transformer_hybrid_W64_K4_student", {})
    k4_cross = _best(k4s, "val_cross_recon")
    if k4_cross is None or k4 is None:
        crits.append(Criterion("C12", "K4 student cross-recon within 3x of "
                               "K4 teacher recon", None,
                               "K4 student runs missing"))
    else:
        crits.append(Criterion("C12", "K4 student cross-recon within 3x of "
                               "K4 teacher recon", k4_cross <= 3.0 * k4,
                               f"cross={k4_cross:.4g} vs teacher recon="
                               f"{k4:.4g} ({k4_cross / k4:.2f}x)"))

    # ---- C7: flagship PPL stability across seeds ----
    flag_ppl = data.get("transformer_hybrid", {}).get("perplexity", [])
    if not flag_ppl:
        crits.append(Criterion("C7", "every flagship seed ends with FSQ PPL > 200",
                               None, "flagship runs missing"))
    else:
        finals = [float(np.mean(s[-5:])) for s in flag_ppl]
        crits.append(Criterion("C7", "every flagship seed ends with FSQ PPL > 200",
                               all(p > 200 for p in finals),
                               f"per-seed final ppl={[round(p,1) for p in finals]}"))
    return crits


_SCALING_PATHS = ("abruns/prior_scale_val/scaling.json",
                  "abruns/prior_scale2/scaling.json")
_COND_PATH = "abruns/prior_cond/conditioned.json"
_PROMPTED_PATH = "abruns/prior_scale2/prompted_1280.json"


def evaluate_generation(scaling_paths=_SCALING_PATHS,
                        cond_path: str = _COND_PATH,
                        prompted_path: str = _PROMPTED_PATH,
                        ) -> List[Criterion]:
    """Generative-stack criteria G1-G5 (docstring above) from the committed
    corpus-scaling / conditioned-prior experiment JSONs."""
    arms: Dict[str, Dict] = {}  # "file:takesN" -> arm report (untagged only)
    for path in scaling_paths:
        if not os.path.exists(path):
            continue
        data = _read_json(path)
        src = os.path.basename(os.path.dirname(path))
        for key, rep in data.items():
            if re.fullmatch(r"takes(\d+)", key):
                arms[f"{src}:{key}"] = rep
    crits: List[Criterion] = []

    def n_takes(label):
        return int(label.rsplit("takes", 1)[1])

    def prompted(rep):
        for k, v in rep.items():
            if k.startswith("prompted_val_P"):
                return v
        return None

    # G1: held-out continuation beats the retrieval floor at >= 160 takes
    big = {k: v for k, v in arms.items() if n_takes(k) >= 160}
    if not big:
        crits.append(Criterion("G1", "held-out continuation truth_mse < "
                               "val_nn_floor at every arm >= 160 takes",
                               None, "scaling arms missing"))
    else:
        details, failed, missing = [], False, False
        for k, rep in sorted(big.items(), key=lambda kv: n_takes(kv[0])):
            prow = prompted(rep)
            if prow is None:
                # an arm written mid-queue without its prompted eval: not
                # evaluable, unless another arm fails (a failure wins, where
                # the JAX package's loop reports n/a once a row is missing)
                missing = True
                details.append(f"{k}: prompted row missing")
                continue
            tm = float(np.mean(prow["truth_mse_by_offset"]))
            floor = rep["val_nn_floor"]
            failed |= not tm < floor
            details.append(f"{k}: {tm:.3f} < {floor:.3f}")
        crits.append(Criterion("G1", "held-out continuation truth_mse < "
                               "val_nn_floor at every arm >= 160 takes",
                               False if failed else (None if missing else True),
                               "; ".join(details)))

    # G2: frozen-tokenizer recon floor stays in the measured class
    if not arms:
        crits.append(Criterion("G2", "tokenizer recon_floor <= 8e-3 on every "
                               "arm (measured ~0.0037)", None,
                               "scaling arms missing"))
    else:
        floors = {k: rep["recon_floor"] for k, rep in arms.items()}
        worst = max(floors, key=floors.get)
        crits.append(Criterion("G2", "tokenizer recon_floor <= 8e-3 on every "
                               "arm (measured ~0.0037)",
                               floors[worst] <= 8e-3,
                               f"worst {worst}: {floors[worst]:.4f}"))

    # G3 + G4 anchor on the largest arm (the committed flagship corpus)
    if arms:
        top = max(arms, key=n_takes)
        rep = arms[top]
        dce = rep["val_ce_epoch0"] - rep["val_ce_best"]
        crits.append(Criterion("G3", "largest arm improves grouped-val CE "
                               ">= 0.5 nats from epoch 0",
                               dce >= 0.5,
                               f"{top}: {rep['val_ce_epoch0']:.2f} -> "
                               f"{rep['val_ce_best']:.2f} (-{dce:.2f})"))
        fr = rep["free_run"]
        ok = (fr["vel_ratio"] >= 0.15
              and fr["overlap_disagreement"] <= 0.30)
        crits.append(Criterion("G4", "largest-arm free-run bands: vel_ratio "
                               ">= 0.15, overlap-dis <= 0.30 (ceiling "
                               "0.93/0.041)", ok,
                               f"{top}: vel {fr['vel_ratio']:.2f}, "
                               f"overlap {fr['overlap_disagreement']:.3f}"))
    else:
        crits.append(Criterion("G3", "largest arm improves grouped-val CE "
                               ">= 0.5 nats from epoch 0", None,
                               "scaling arms missing"))
        crits.append(Criterion("G4", "largest-arm free-run bands: vel_ratio "
                               ">= 0.15, overlap-dis <= 0.30 (ceiling "
                               "0.93/0.041)", None, "scaling arms missing"))

    # G5: conditioned prior steers sampling (histogram match), adjudicated
    # as sampler-level control (conditioning info gain ~0 nats — the class
    # is inferable from the prefix; docs/ROUND4.md)
    if os.path.exists(cond_path):
        cond = _read_json(cond_path)
        rep = cond.get("perclass12")
        if rep is None:
            crits.append(Criterion("G5", "conditioned sampling histogram-"
                                   "match accuracy = 1.0 at perclass12",
                                   None, "perclass12 arm missing from "
                                   "conditioned.json"))
        else:
            hm = rep["histogram_match"]
            crits.append(Criterion("G5", "conditioned sampling histogram-"
                                   "match accuracy = 1.0 at perclass12",
                                   hm["accuracy"] >= 1.0,
                                   f"match {hm['accuracy']:.2f} over "
                                   f"{hm['n_classes']} classes; cond gain "
                                   f"{rep['conditioning_gain_nats']:+.3f} "
                                   "nats (sampler-level control)"))
    else:
        crits.append(Criterion("G5", "conditioned sampling histogram-match "
                               "accuracy = 1.0 at perclass12", None,
                               "conditioned.json missing"))

    # G6: guided continuation strictly beats unguided (adopted in
    # docs/ROUND4.md): truth-MSE mean over offsets <= 3 at least
    # 1.5x lower AND seam disagreement lower, prompted P8 on the largest
    # committed prior
    if os.path.exists(prompted_path):
        rows = _read_json(prompted_path)
        base = next((v for k, v in rows.items() if k.endswith("|P8")), None)
        guided = next((v for k, v in rows.items()
                       if "|P8|g" in k), None)
        if base and guided:
            def near_truth(rep):
                offs = rep["offsets"]
                tm = rep["truth_mse_by_offset"]
                return float(np.mean([t for o, t in zip(offs, tm) if o <= 3]))
            tb, tg = near_truth(base), near_truth(guided)
            sb = base["overlap_disagreement_seam"]
            sg = guided["overlap_disagreement_seam"]
            ok = tg * 1.5 <= tb and sg < sb
            crits.append(Criterion(
                "G6", "guided continuation >= 1.5x lower near-offset "
                "truth-MSE and lower seam vs unguided (P8)",
                ok, f"truth<=off3 {tg:.3f} vs {tb:.3f} "
                    f"({tb / max(tg, 1e-9):.1f}x); seam {sg:.3f} vs {sb:.3f}"))
        else:
            crits.append(Criterion(
                "G6", "guided continuation >= 1.5x lower near-offset "
                "truth-MSE and lower seam vs unguided (P8)", None,
                "P8 rows missing"))
    else:
        crits.append(Criterion(
            "G6", "guided continuation >= 1.5x lower near-offset truth-MSE "
            "and lower seam vs unguided (P8)", None,
            "prompted_1280.json missing"))
    return crits


def render_parity_md(crits: List[Criterion], log_dir: str = "results") -> str:
    lines = [
        "# PARITY — quality-parity criteria vs BASELINE.md",
        "",
        "Auto-generated by `python scripts/check_parity.py` from "
        f"`{log_dir}/log_*.json`. Criteria are data-independent method",
        "signatures (absolute values cannot match: the reference dataset is",
        "unreachable under zero egress; see bridgerl_tpu/eval/parity.py for",
        "the rationale of each threshold).",
        "",
        "| id | criterion | status | detail |",
        "|---|---|---|---|",
    ]
    for c in crits:
        status = "PASS" if c.passed else ("FAIL" if c.passed is not None else "n/a")
        lines.append(f"| {c.cid} | {c.description} | **{status}** | {c.detail} |")
    n_pass = sum(1 for c in crits if c.passed)
    n_eval = sum(1 for c in crits if c.passed is not None)
    lines += ["", f"**{n_pass}/{n_eval} evaluable criteria pass** "
                  f"({len(crits) - n_eval} not yet evaluable).", ""]
    return "\n".join(lines)
