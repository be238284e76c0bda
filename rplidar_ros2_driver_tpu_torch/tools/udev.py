"""udev rule generator — equivalent of scripts/create_udev_rules.sh.

The reference script writes ``/etc/udev/rules.d/99-rplidar.rules`` matching
the CP210x USB-UART bridge (10c4:ea60), symlinking it to ``/dev/rplidar``
with MODE 0666 and group ``dialout``, then reloads udev
(scripts/create_udev_rules.sh:36-57).  This module generates the same rule
text; installation is explicit and root-gated.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

RULES_PATH = "/etc/udev/rules.d/99-rplidar.rules"

# CP210x USB-UART bridge used by every RPLIDAR dev kit.
USB_VENDOR = "10c4"
USB_PRODUCT = "ea60"


def udev_rules_text(symlink: str = "rplidar", mode: str = "0666", group: str = "dialout") -> str:
    return (
        "# RPLIDAR: Silicon Labs CP210x USB-UART bridge -> stable /dev/%s symlink\n"
        'KERNEL=="ttyUSB*", ATTRS{idVendor}=="%s", ATTRS{idProduct}=="%s", '
        'MODE:="%s", GROUP:="%s", SYMLINK+="%s"\n' % (symlink, USB_VENDOR, USB_PRODUCT, mode, group, symlink)
    )


def install(
    rules_path: str = RULES_PATH, *, symlink: str = "rplidar", reload_udev: bool = True
) -> None:
    """Write the rules file and reload udev (requires root)."""
    if os.geteuid() != 0:
        raise PermissionError("installing udev rules requires root")
    with open(rules_path, "w") as f:
        f.write(udev_rules_text(symlink))
    if reload_udev:
        # same reload+trigger sequence as the reference script
        subprocess.run(["udevadm", "control", "--reload-rules"], check=False)
        subprocess.run(["udevadm", "trigger"], check=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Generate/install RPLIDAR udev rules")
    ap.add_argument("--install", action="store_true", help=f"write {RULES_PATH} (root)")
    ap.add_argument("--symlink", default="rplidar")
    args = ap.parse_args(argv)
    if args.install:
        install(symlink=args.symlink)
        print(f"installed {RULES_PATH}")
    else:
        sys.stdout.write(udev_rules_text(args.symlink))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
