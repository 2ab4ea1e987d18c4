#!/usr/bin/env python
"""Dump device/topology info — role of the reference's machines_info/
(lstopo + lscpu dumps): what hardware did these numbers come from.

Usage: python tools/machine_info.py
"""
import dataclasses
import json
import sys

sys.path.insert(0, ".")


def main():
    import jax
    from spmv_research_tpu.utils.roofline import device_spec
    from spmv_research_tpu.utils.runtime import device_record

    info = device_record()
    info["devices"] = [str(d) for d in jax.devices()]
    info["process_count"] = jax.process_count()
    try:
        info["published_peaks"] = dataclasses.asdict(device_spec())
    except ValueError as e:          # no table row (e.g. the CPU backend)
        info["published_peaks"] = str(e)
    print(json.dumps(info, indent=2))


if __name__ == "__main__":
    main()
