"""Timestamped stderr progress logging (reference: src/util.h:276-282)."""
import sys
import time


def loginfo(msg: str):
    t = time.localtime()
    sys.stderr.write("[%02d:%02d:%02d] %s \n"
                     % (t.tm_hour, t.tm_min, t.tm_sec, msg))
