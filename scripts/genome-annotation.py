#!/usr/bin/env python3
"""Turn kaamer-jax nucleotide-search TSV output into a GFF3 genome annotation.

Capability match for the reference scripts/genome-annotation.py: group hits
by query location, build a consensus product/gene name per CDS (majority
vote, falling back to the best hit), resolve overlapping CDS calls (>60 bp
overlaps keep only the higher-scoring feature), and emit GFF3 CDS lines.

Usage: genome-annotation.py --kaamer_res results.tsv [--minId 90] [--minLen 60]
"""

from __future__ import annotations

import argparse
import re
import sys
from collections import Counter


def consensus_feature(group: list) -> dict:
    names = [re.sub(r" \{.+\}", "", ft.get("ProteinName", "")) for ft in group]
    genes = [ft.get("GeneName", "") for ft in group]
    best = max(ft["pId"] for ft in group)
    ft = dict(group[0])
    if len(set(names)) < len(names):
        ft["ProteinName"] = Counter(names).most_common(1)[0][0]
        if genes:
            ft["GeneName"] = Counter(genes).most_common(1)[0][0]
    ft["pId"] = best
    return ft


def resolve_overlaps(features: list) -> list:
    kept = []
    for ft in features:
        if not kept:
            kept.append(ft)
            continue
        q0, q1 = sorted((int(ft["QStart"]), int(ft["QEnd"])))
        l0, l1 = sorted((int(kept[-1]["QStart"]), int(kept[-1]["QEnd"])))
        if q0 < l1 and q1 <= l1:
            if ft["pId"] > kept[-1]["pId"]:
                kept[-1] = ft
        elif q0 < l1 < q1:
            if (l1 - q0) < 60:
                kept.append(ft)
        elif q0 >= l1:
            kept.append(ft)
    return kept


def emit_gff(features: list, product_col: str, gene_col: str, out) -> None:
    out.write("##gff-version 3\n")
    for ft in features:
        start, end = int(ft["QStart"]), int(ft["QEnd"])
        strand = "+"
        if start > end:
            start, end = end, start
            strand = "-"
        attrs = ["ID=" + ft["SubjectId"]]
        if ft.get(product_col):
            attrs.append("product=" + ft[product_col])
        if ft.get(gene_col):
            attrs.append("gene=" + ft[gene_col])
        out.write(
            f"{ft['QueryId']}\t.\tCDS\t{start}\t{end}\t.\t{strand}\t.\t"
            f"{';'.join(attrs)}\n"
        )


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Create a GFF3 annotation from kaamer TSV results"
    )
    ap.add_argument("--kaamer_res", help="kaamer results TSV file")
    ap.add_argument("--stream", action="store_true", help="read TSV from stdin")
    ap.add_argument("--minId", type=float, default=90.0)
    ap.add_argument("--minLen", type=float, default=60)
    ap.add_argument("--ftProduct", default="ProteinName")
    ap.add_argument("--ftGene", default="GeneName")
    args = ap.parse_args()

    if args.kaamer_res:
        reader = open(args.kaamer_res)
    elif args.stream:
        reader = sys.stdin
    else:
        ap.print_help()
        return 1

    header = reader.readline().rstrip("\n").split("\t")
    pid_col = "%Identity" if "%Identity" in header else "%KMatchIdentity"

    groups = {}
    order = []
    for line in reader:
        ft = dict(zip(header, line.rstrip("\n").split("\t")))
        lo = min(int(ft["QStart"]), int(ft["QEnd"]))
        hi = max(int(ft["QStart"]), int(ft["QEnd"]))
        if (hi - lo) / 3 < args.minLen:
            continue
        ft["pId"] = float(ft[pid_col])
        if ft["pId"] < args.minId:
            continue
        key = (ft["QueryId"], ft["QStart"], ft["QEnd"])
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(ft)

    features = [consensus_feature(groups[k]) for k in order]
    features.sort(key=lambda ft: min(int(ft["QStart"]), int(ft["QEnd"])))
    features = resolve_overlaps(features)
    emit_gff(features, args.ftProduct, args.ftGene, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
