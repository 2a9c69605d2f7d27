import os
import sys

# `fastp_tpu_torch serve --socket ...`: resident server mode (see server.py)
if len(sys.argv) >= 2 and sys.argv[1] == "serve":
    from .server import serve_main
    sys.exit(serve_main(sys.argv[2:]))

# When FASTP_TPU_SERVER names a server's socket, the job goes there through
# the thin client, before torch is imported.  STDIN-streaming jobs stay
# local; an unreachable server means a local run, which says so.
_srv = os.environ.get("FASTP_TPU_SERVER")
if (_srv and os.path.exists(_srv) and "--stdin" not in sys.argv
        and "/dev/stdin" not in sys.argv
        # the --local_processes launcher must run locally (its CHILDREN
        # are what route to servers, one per card via FASTP_TPU_SERVERS)
        and not any(a.startswith("--local_processes") for a in sys.argv)):
    from .client import run_via_server
    _rc = run_via_server(_srv, sys.argv)
    if _rc is not None:
        sys.exit(_rc)
    sys.stderr.write("fastp_tpu_torch: no server answers on %s; running "
                     "locally\n" % _srv)

from .cli import main

sys.exit(main())
