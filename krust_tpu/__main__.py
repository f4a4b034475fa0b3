"""``python -m`` under the package's former name: the ``kmix`` CLI."""

import sys

from krust.cli import main

if __name__ == "__main__":
    sys.exit(main())
