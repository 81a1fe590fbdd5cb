import sys

from .host.main import main

sys.exit(main())
