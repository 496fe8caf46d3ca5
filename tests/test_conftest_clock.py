# The per-test clock that the repository's conftest.py installs
# (tests/clock.py: Clock): a child pytest runs a throwaway file with the
# clock at a 2 s limit. The test that sleeps past it fails well before its
# sleep ends, with the sleeping frame and every thread's stack in the
# report; the quick test in the same file still passes.

import os
import subprocess
import sys
import textwrap
import xml.etree.ElementTree as ET

import clock

TESTS = textwrap.dedent("""
    import time

    def test_sleeps_past_the_limit():
        time.sleep(30)

    def test_quick():
        time.sleep(0.1)
""")

CHILD = """
import sys
sys.path.insert(0, {tests!r})
import pytest
import clock
sys.exit(pytest.main([{file!r}, "-p", "no:cacheprovider", "-p", "no:xdist",
                      "--junitxml", {xml!r}], plugins=[clock.Clock(2)]))
"""


def test_clock_fails_a_sleeping_test_and_passes_a_quick_one(tmp_path):
    file, xml = tmp_path / "test_sleeper.py", tmp_path / "out.xml"
    file.write_text(TESTS)
    code = CHILD.format(tests=os.path.dirname(clock.__file__),
                        file=str(file), xml=str(xml))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True,
                       timeout=clock.CHILD_LIMIT_S)
    assert r.returncode == 1, r.stdout + r.stderr
    cases = {c.get("name"): c for c in ET.parse(xml).iter("testcase")}
    slow, quick = cases["test_sleeps_past_the_limit"], cases["test_quick"]
    assert slow.find("failure") is not None
    assert float(slow.get("time")) < 10.0, slow.get("time")
    assert "2 s limit" in slow.find("failure").get("message")
    assert "time.sleep(30)" in r.stdout
    assert "most recent call first" in r.stdout
    assert all(quick.find(tag) is None
               for tag in ("failure", "error", "skipped"))
