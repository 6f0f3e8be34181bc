from sphjax.cli import main

raise SystemExit(main())
