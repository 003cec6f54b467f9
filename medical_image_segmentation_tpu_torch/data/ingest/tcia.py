"""TCIA manifest parsing + series download (the reference's L0 layer).

The reference ships 10 `.tcia` download manifests
(`data/tcia_manifests/*.tcia`, SURVEY §1 L0) consumed by the NBIA Data
Retriever. A `.tcia` manifest is a small text format:

    downloadServerUrl=https://public.cancerimagingarchive.net/nbia-download/servlet/DownloadServlet
    databasketId=manifest-xxx.tcia
    manifestVersion=3.0
    ListOfSeriesToDownload=
    1.3.6.1.4.1.14519...   (one SeriesInstanceUID per line)
    ...

This module parses manifests and (when the machine has egress) fetches
series via TCIA's public REST API (`getImage?SeriesInstanceUID=...` returns
a zip of DICOMs). Downloads are best-effort with per-series statuses,
matching the ingest stage's fault-tolerance contract.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import zipfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

TCIA_REST_BASE = "https://services.cancerimagingarchive.net/services/v4/TCIA/query"


@dataclass
class TciaManifest:
    server_url: str = ""
    version: str = ""
    series_uids: List[str] = field(default_factory=list)
    extra: Dict[str, str] = field(default_factory=dict)


def parse_manifest(path: str) -> TciaManifest:
    m = TciaManifest()
    in_list = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if in_list:
                m.series_uids.append(line)
            elif line.startswith("ListOfSeriesToDownload="):
                in_list = True
                rest = line.split("=", 1)[1]
                if rest:
                    m.series_uids.append(rest)
            elif "=" in line:
                k, v = line.split("=", 1)
                if k == "downloadServerUrl":
                    m.server_url = v
                elif k == "manifestVersion":
                    m.version = v
                else:
                    m.extra[k] = v
    return m


def download_series(series_uid: str, out_dir: str, timeout: float = 120.0) -> dict:
    """Fetch one series as DICOMs via the TCIA REST API (needs egress)."""
    import urllib.request

    url = f"{TCIA_REST_BASE}/getImage?SeriesInstanceUID={series_uid}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            blob = resp.read()
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            for name in zf.namelist():
                if name.endswith(".dcm"):
                    zf.extract(name, out_dir)
                    n += 1
        return {"files": n}
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Parse/download TCIA manifests")
    ap.add_argument("manifest", help=".tcia manifest path")
    ap.add_argument("--output_dir", default=None, help="download destination (omit to only list)")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)
    m = parse_manifest(args.manifest)
    uids = m.series_uids[: args.limit] if args.limit else m.series_uids
    print(f"{os.path.basename(args.manifest)}: {len(m.series_uids)} series "
          f"(manifest v{m.version})", file=sys.stderr)
    if not args.output_dir:
        for u in uids:
            print(u)
        return 0
    ok = 0
    for u in uids:
        st = download_series(u, os.path.join(args.output_dir, u))
        if "files" in st:
            ok += 1
        else:
            print(f"  {u}: {st['error']}", file=sys.stderr)
    print(f"downloaded {ok}/{len(uids)} series", file=sys.stderr)
    return 0 if ok == len(uids) else 1


if __name__ == "__main__":
    raise SystemExit(main())
