"""Human-readable text for event codes.

The numeric codes (``codes.py``, ``LOG_CODES.md``) are the machine contract
shared with the reference implementation; the sentences below are this
framework's own wording.  ``get_explanation_handler(show_codes=True)``
prepends the numeric code so a remote consumer can parse it back out.
"""

from .codes import Code

_TEXT = {
    Code.INFO_UPLOADING: "Receiving input files",
    Code.INFO_WAITING: "Job queued, waiting for a processing slot",
    Code.INFO_LOADING: "Decoding and validating the input tracks",
    Code.INFO_MATCHING_LEVELS: "Stage 1/4: aligning loudness",
    Code.INFO_MATCHING_FREQS: "Stage 2/4: shaping the frequency response",
    Code.INFO_CORRECTING_LEVELS: "Stage 3/4: refining loudness after EQ",
    Code.INFO_FINALIZING: "Stage 4/4: rendering the output variants",
    Code.INFO_EXPORTING: "Encoding the requested output files",
    Code.INFO_MAKING_PREVIEWS: "Rendering preview snippets",
    Code.INFO_COMPLETED: "Done — mastering finished",
    Code.INFO_TARGET_IS_MONO: "TARGET is mono; duplicating it into both stereo channels",
    Code.INFO_REFERENCE_IS_MONO: "REFERENCE is mono; duplicating it into both stereo channels",
    Code.INFO_REFERENCE_IS_RESAMPLED: "REFERENCE converted to the internal sample rate",
    Code.INFO_REFERENCE_IS_LOSSY: "REFERENCE appears to come from a lossy codec",
    Code.WARNING_TARGET_IS_CLIPPING: (
        "TARGET contains clipped samples — results improve with an "
        "unclipped bounce of the mix"
    ),
    Code.WARNING_TARGET_LIMITER_IS_APPLIED: (
        "TARGET looks already limited — results improve with a bounce "
        "that skips the limiter"
    ),
    Code.WARNING_TARGET_IS_RESAMPLED: (
        "TARGET converted to the internal sample rate (its native rate "
        "differed)"
    ),
    Code.WARNING_TARGET_IS_LOSSY: (
        "TARGET appears to come from a lossy codec — prefer a lossless "
        "source (WAV, FLAC or AIFF)"
    ),
    Code.ERROR_TARGET_LOADING: "Could not decode an audio stream from TARGET",
    Code.ERROR_TARGET_LENGTH_IS_EXCEEDED: "TARGET runs longer than the configured maximum",
    Code.ERROR_TARGET_LENGTH_IS_TOO_SMALL: "TARGET is shorter than the configured minimum",
    Code.ERROR_TARGET_NUM_OF_CHANNELS_IS_EXCEEDED: "TARGET has more channels than stereo",
    Code.ERROR_TARGET_EQUALS_REFERENCE: (
        "TARGET and REFERENCE hold identical audio — matching a track "
        "against itself is a no-op"
    ),
    Code.ERROR_REFERENCE_LOADING: "Could not decode an audio stream from REFERENCE",
    Code.ERROR_REFERENCE_LENGTH_LENGTH_IS_EXCEEDED: "REFERENCE runs longer than the configured maximum",
    Code.ERROR_REFERENCE_LENGTH_LENGTH_TOO_SMALL: "REFERENCE is shorter than the configured minimum",
    Code.ERROR_REFERENCE_NUM_OF_CHANNELS_IS_EXCEEDED: "REFERENCE has more channels than stereo",
    Code.ERROR_UNKNOWN: "Unexpected internal error",
    Code.ERROR_VALIDATION: (
        "Internal validation failed after preprocessing — please report "
        "this as a bug"
    ),
}


def explain(code: Code) -> str:
    return _TEXT[code]


def explain_with_code(code: Code) -> str:
    return f"{code}: {_TEXT[code]}"


def get_explanation_handler(show_codes: bool = False):
    return explain_with_code if show_codes else explain
